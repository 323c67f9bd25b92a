"""qwen2-7b  [arXiv:2407.10671].  GQA kv=4, QKV bias.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True,
    norm_type="rmsnorm", mlp_act="silu", gated_mlp=True,
    rope_theta=1e6,
    source="arXiv:2407.10671",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=56, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512, remat=False)
