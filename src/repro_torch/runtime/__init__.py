"""Runtime subsystems: the precision-scalable CIM inference engine (single-
and multi-macro sharded dispatch), the plan-once/serve-many compiled-program
layer on top of it, the continuous in-flight batching scheduler over that
layer, plus the elastic-mesh and fault-tolerance helpers used by the
training launcher (`runtime.elastic`, `runtime.fault_tolerance`).

Counterpart of `repro/runtime/__init__.py`, exporting the same names."""
from repro_torch.runtime.engine import (CIMInferenceEngine,  # noqa: F401
                                        EngineConfig, LayerPlan,
                                        NetworkPlan, ShardingConfig,
                                        im2col_patches, plan_layer,
                                        plan_network, run_network,
                                        run_network_reference)
from repro_torch.runtime.program import (BatchBuckets,  # noqa: F401
                                         BoundProgram, CIMProgram,
                                         SharedInputBind,
                                         SharedInputProgram,
                                         clear_program_cache,
                                         compile_program,
                                         program_cache_stats,
                                         program_for_plan,
                                         request_noise_ids)
from repro_torch.runtime.scheduler import (CIMDecodeLM,  # noqa: F401
                                           DecodeBlock, InflightScheduler,
                                           Request, RequestRecord, SlotMap,
                                           decode_sequential)
