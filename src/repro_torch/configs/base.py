"""Model/config schema shared by the architectures and the launcher.

Counterpart of `repro/configs/base.py`, with the port's own `CIMConfig`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.cim_layers import CIMConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # attention flavour
    qkv_bias: bool = False
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm | nonparam_ln
    sliding_window: int = 0       # SWA (mixtral); 0 = full attention
    rope_theta: float = 1e6
    mlp_act: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # hybrid (recurrentgemma / griffin)
    attn_every: int = 0           # every k-th layer is local attention
    local_window: int = 2048
    lru_width: int = 0
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # enc-dec (whisper)
    encoder_layers: int = 0
    max_target_len: int = 448
    # vlm
    vision_tokens: int = 0        # prefix patch embeddings (stub frontend)
    # execution
    cim: CIMConfig = CIMConfig(mode="bypass")
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"    # full | dots (save dot outputs in bwd)
    attn_impl: str = "jnp"        # jnp | pallas (the flash kernels)
    # source provenance (paper/hf tag from the assignment)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs with at least one sub-quadratic decode path run long_500k
SUBQUADRATIC = {"mixtral-8x22b", "recurrentgemma-2b", "mamba2-1.3b"}


def shape_applicable(arch: str, shape: str, family: str) -> Tuple[bool, str]:
    """(whether `arch` runs `shape`, the reason where it does not): the
    dry run skips the 500k decode of a pure full-attention arch."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("pure full-attention arch: 500k decode skipped "
                       "(DESIGN.md §4)")
    return True, ""
