"""minitron-4b (pruned nemotron)  [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000,
    head_dim=128,                     # nemotron uses 128-dim heads
    norm_type="rmsnorm", mlp_act="relu2", gated_mlp=False,  # squared-relu MLP
    rope_theta=1e4,
    source="arXiv:2407.14679",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=192, vocab_size=512, remat=False)
