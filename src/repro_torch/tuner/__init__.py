"""Roofline-driven schedule autotuner for compiled CIM programs.

Counterpart of `repro/tuner/`.  Three pieces, one invariant:

  * `cost` - the analytic per-layer roofline model: the IMAGINE macro's
    evaluations, and the Hopper route's HBM bytes and wave-filled
    operations at a tile, on the shared `core.hw` tables (`H100_SXM`).
  * `search` - the plan-time candidate scan (`tune_network`), heuristic
    candidate scored first so tuned cost <= heuristic cost always.
  * `cache` - the versioned on-disk winner store
    ($REPRO_TORCH_AUTOTUNE_CACHE or ~/.cache/repro-cim/autotune_torch.json);
    corrupt or stale files degrade to the heuristic with a warning, never
    a crash.

The invariant: tuning NEVER changes numerics.  The knob is the cim_mbiw
route's tile (`kernel.legal_tiles`), which only moves where the exact
int32 sums are taken, so a tuned program's outputs are bit-identical to
the heuristic program's (tests/test_torch_tuner.py on the CPU,
tests/test_torch_gpu.py and chip_smoke.py on the card).

Entry points: `runtime.program.compile_program(..., tune="analytic")`
for the integrated path, or `search.tune_network` directly.
"""
from repro_torch.tuner.cache import (SCHEMA_VERSION, TuneCache,
                                     TuneCacheWarning, cache_key,
                                     default_cache_path)
from repro_torch.tuner.cost import (LayerCost, ScheduleChoice,
                                    kernel_dma_bytes, layer_cost)
from repro_torch.tuner.search import (SEARCH_COUNT, heuristic_choice,
                                      layer_candidates, tune_layer,
                                      tune_network)

__all__ = [
    "SCHEMA_VERSION", "TuneCache", "TuneCacheWarning", "cache_key",
    "default_cache_path", "LayerCost", "ScheduleChoice", "kernel_dma_bytes",
    "layer_cost", "SEARCH_COUNT", "heuristic_choice", "layer_candidates",
    "tune_layer", "tune_network",
]
