"""olmo-1b  [arXiv:2402.00838].  Non-parametric LayerNorm, untied heads=kv.

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm_type="nonparam_ln", mlp_act="silu", gated_mlp=True,
    rope_theta=1e4,
    tie_embeddings=True,              # OLMo-1B ties the LM head
    source="arXiv:2402.00838",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_ff=128, vocab_size=512, remat=False)
