"""granite-8b (code)  [arXiv:2405.04324].  Llama-arch.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=49152,
    norm_type="rmsnorm", mlp_act="silu", gated_mlp=True,
    rope_theta=1e4,
    source="arXiv:2405.04324",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512, remat=False)
