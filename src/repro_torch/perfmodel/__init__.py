"""The IMAGINE macro's cycle and energy model (`macro_perf`), the port's
copy of `repro.perfmodel`: the same floats from the same plans."""
from repro_torch.perfmodel.macro_perf import (AcceleratorPerfModel,  # noqa
                                              CyclePerf, EnergyModel,
                                              cim_eval_time_ns, cycle_model,
                                              schedule_report)
