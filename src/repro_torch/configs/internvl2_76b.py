"""internvl2-76b  [arXiv:2404.16821].  InternViT frontend (stub) + InternLM2.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The vision
frontend is a stub per the assignment: input_specs() provides precomputed
patch embeddings (vision_tokens x d_model) prepended to the text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    vision_tokens=256,
    norm_type="rmsnorm", mlp_act="silu", gated_mlp=True,
    rope_theta=1e6,
    source="arXiv:2404.16821 (unverified)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab_size=512, vision_tokens=8,
                          remat=False)
