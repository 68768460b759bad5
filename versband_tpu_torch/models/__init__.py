from versband_tpu_torch.models.autoencoder import AutoencoderKL, Encoder1D, Decoder1D  # noqa: F401
from versband_tpu_torch.models.autoencoder2d import (  # noqa: F401
    AutoencoderKL2D, VQModel, VQModelInterface, IdentityFirstStage)
from versband_tpu_torch.models.cfm import CFM, CFMSampler, LatentDiffusion  # noqa: F401
from versband_tpu_torch.models.dit import BandMoeDiT  # noqa: F401
from versband_tpu_torch.models.dit_timefreq import TimeFreqMoeDiT  # noqa: F401
from versband_tpu_torch.models.concat_dit import (  # noqa: F401
    ConcatDiT, ConcatDiT2MLP, HybridDiT2MLP, HybridDiT2MLP2, ConcatOrderDiT, ConcatOrderDiT2)
from versband_tpu_torch.models.samplers import (  # noqa: F401
    DDIMSampler, PLMSSampler, ddpm_sample_loop)
from versband_tpu_torch.models.schedules import DiffusionSchedule  # noqa: F401
from versband_tpu_torch.models.distributions import DiagonalGaussian  # noqa: F401
