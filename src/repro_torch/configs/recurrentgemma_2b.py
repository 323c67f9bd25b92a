"""recurrentgemma-2b  [arXiv:2402.19427].  RG-LRU + local attn, 1:2 pattern.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000,
    head_dim=256,
    attn_every=3, local_window=2048, lru_width=2560,
    norm_type="rmsnorm", mlp_act="gelu", gated_mlp=True,
    rope_theta=1e4,
    tie_embeddings=True,
    source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=5, d_model=64, n_heads=2, n_kv_heads=1,
                          head_dim=32, d_ff=128, vocab_size=512,
                          local_window=16, lru_width=64, remat=False)
