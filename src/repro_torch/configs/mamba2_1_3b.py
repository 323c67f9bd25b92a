"""mamba2-1.3b  [arXiv:2405.21060].  SSD (state-space duality), attn-free.

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    norm_type="rmsnorm",
    source="arXiv:2405.21060 (unverified)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, vocab_size=512,
                          ssm_state=16, ssm_headdim=16, ssm_chunk=16,
                          remat=False)
