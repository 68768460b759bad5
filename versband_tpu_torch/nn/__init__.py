from versband_tpu_torch.nn.core import (  # noqa: F401
    RMSNorm, modulate, timestep_embedding, TimestepEmbedder, ConditionEmbedder,
    swiglu_hidden_dim, FeedForward, precompute_rope, apply_rope, sdpa, attention,
    JointAttention,
)
