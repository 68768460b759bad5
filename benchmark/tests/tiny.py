"""A tiny cell for the CPU tests: the serving configuration and traffic cut
to widths and lengths the CPU runs in seconds (HiFi-GAN stays at its
published widths: ``build_vocoder`` builds it so)."""

from __future__ import annotations

import copy

from benchmark.lib import cells

T5 = dict(d_model=32, d_ff=64, d_kv=8, num_heads=4, num_layers=2,
          feed_forward_proj="gated-gelu", vocab_size=1000,
          relative_attention_num_buckets=32, relative_attention_max_distance=128,
          layer_norm_epsilon=1e-6)


def tiny_cell(name: str = "accomp_band.serve", frames: int = 48, takes: int = None):
    cell = copy.deepcopy(cells.cell(name))
    model = cell["config_data"]["model"]["params"]
    dit = model["unet_config"]["params"]
    dit.update(hidden_size=64, num_heads=2, depth=1, ori_dim=32, context_dim=64)
    vae = model["first_stage_config"]["params"]["ddconfig"]
    vae.update(ch=32, ch_mult=[1, 2])
    model["cond_stage_config"]["params"]["fallback_config"] = dict(T5)
    model["cond_stage_config"]["params"]["max_length"] = 16
    mix = cell["traffic_data"]
    mix.update(mel_frames=frames, timesteps=4, warmup_requests=1, checked_requests=1,
               checked_from_first=1, traced_requests=2)
    if takes is not None:
        mix["takes"] = takes
    return cell


def tiny_train_cell():
    cell = copy.deepcopy(cells.cell("accomp_band.train"))
    model = cell["config_data"]["model"]["params"]
    model["unet_config"]["params"].update(hidden_size=64, num_heads=2, depth=1, ori_dim=32,
                                          context_dim=64)
    model["first_stage_config"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2])
    model["cond_stage_config"]["params"]["fallback_config"] = dict(T5)
    model["cond_stage_config"]["params"]["max_length"] = 16
    cell["config_data"]["data"]["params"]["num_workers"] = 2
    cell["traffic_data"].update(songs=3, song_s=[3, 5], rows=700, batch_size=2,
                                crop_frames=128, padded_frames=384, warmup_steps=1,
                                traced_steps=2)
    return cell


def tiny_vae_cell():
    cell = copy.deepcopy(cells.cell("accomp_vae.train"))
    cell["config_data"]["model"]["params"]["ddconfig"].update(ch=32, ch_mult=[1, 2])
    cell["config_data"]["data"]["params"]["num_workers"] = 2
    cell["traffic_data"].update(songs=3, song_s=[3, 5], rows=400, batch_size=2,
                                crop_frames=120, padded_frames=128, warmup_steps=1,
                                traced_steps=2)
    return cell
