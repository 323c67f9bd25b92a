"""mixtral-8x22b  [arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    moe_experts=8, moe_top_k=2,
    sliding_window=4096,              # SWA per the assignment
    norm_type="rmsnorm", mlp_act="silu", gated_mlp=True,
    rope_theta=1e6,
    source="arXiv:2401.04088",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=256, moe_experts=4,
                          sliding_window=16, remat=False)
