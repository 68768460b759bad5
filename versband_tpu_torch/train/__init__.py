"""Training of the port: CFM flow matching over frozen-VAE latents (stage 2)."""
