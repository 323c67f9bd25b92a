"""whisper-medium  [arXiv:2212.04356].  Enc-dec; conv frontend stubbed.

24L (enc) + 24L (dec) d_model=1024 16H d_ff=4096 vocab=51865.  The
launchers feed precomputed mel-frame embeddings (B, T, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, encoder_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    max_target_len=448,
    norm_type="layernorm", mlp_act="gelu", gated_mlp=False,
    rope_theta=1e4,
    source="arXiv:2212.04356 (unverified)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, encoder_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
                          max_target_len=32, remat=False)
