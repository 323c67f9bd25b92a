"""Fault-tolerant training driver.

Counterpart of `repro/runtime/fault_tolerance.py`:

  * checkpoint/restart - the driver checkpoints every `ckpt_every` steps
    through `checkpoint.CheckpointManager` and, after a fault, restarts
    from the newest complete checkpoint (or from the initial state when
    there is none);
  * failure detection - every step records a monotonic heartbeat; a fault
    is emulated by raising `_InjectedFault` at a chosen step
    (`make_fault_injector`);
  * straggler accounting - a step slower than `straggler_factor` x the
    median of the last 100 (once 5 are known) is a straggler; after
    `max_straggler_strikes` in a row the strikes reset (on a cluster:
    replace the slow host);
  * elastic scaling - checkpoints hold logical arrays, so a restart may
    reshard them onto another mesh (`runtime/elastic.py`).

The port's train step updates its tensors in place, so the driver never
reuses a tensor a step has touched: `run` copies the initial state to
the host first (`to_host`) and every restart builds new tensors
(`from_host`) from that copy or from the checkpoint.  By default the host
copy is the state's own tree of numpy arrays and `from_host` places each
leaf as `state_template`'s (device, dtype, requires_grad); the train
launcher passes `convert.train_state_to_numpy` / `train_state_from_numpy`,
so its checkpoints hold JAX's stacked layout.  The clock is read through
this module's `time`, so a test may replace it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import host_tree, place_like


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    heartbeat_timeout_s: float = 300.0
    straggler_factor: float = 2.5
    max_straggler_strikes: int = 5
    max_restarts: int = 3


@dataclasses.dataclass
class StepStats:
    step: int
    loss: float
    duration_s: float
    straggler: bool


class TrainDriver:
    """Drives (state, batch) -> (state, metrics) step functions with
    checkpoint/restart, heartbeat and straggler accounting."""

    def __init__(self, cfg: FTConfig, step_fn: Callable,
                 batch_fn: Callable[[int], Any], state_template: Any, *,
                 to_host: Optional[Callable[[Any], Any]] = None,
                 from_host: Optional[Callable[[Any], Any]] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.manager = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.state_template = state_template
        self.to_host = to_host or host_tree
        self.from_host = from_host or (
            lambda host: place_like(host, state_template))
        self.heartbeat = time.monotonic()
        self.history: List[StepStats] = []
        self._durations: List[float] = []
        self._host_template: Any = None
        self.restarts = 0

    # -- state recovery ----------------------------------------------------
    def restore_or_init(self, init_state: Any) -> tuple[Any, int]:
        """(state, step): the newest checkpoint as new tensors, or
        `init_state` and 0 without one.  A save still being written
        counts: the writer is joined first."""
        self.manager.wait()
        if self.manager.latest_step() is None:
            return init_state, 0
        if self._host_template is None:
            self._host_template = self.to_host(self.state_template)
        host, manifest = self.manager.restore(self._host_template)
        return self.from_host(host), int(manifest["step"])

    # -- main loop ----------------------------------------------------------
    def run(self, init_state: Any, num_steps: int,
            fault_injector: Optional[Callable[[int], None]] = None
            ) -> tuple[Any, List[StepStats]]:
        host_init = self.to_host(init_state)
        self._host_template = host_init
        del init_state

        def recover():
            # build the initial state only where no checkpoint replaces it
            self.manager.wait()
            if self.manager.latest_step() is None:
                return self.from_host(host_init), 0
            return self.restore_or_init(None)

        state, step = recover()
        strikes = 0
        while step < num_steps:
            try:
                if fault_injector is not None:
                    fault_injector(step)
                t0 = time.monotonic()
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics.get("loss", 0.0))
                dt = time.monotonic() - t0
                self.heartbeat = time.monotonic()

                median = (sorted(self._durations)[len(self._durations) // 2]
                          if self._durations else dt)
                is_straggler = (len(self._durations) >= 5
                                and dt > self.cfg.straggler_factor * median)
                strikes = strikes + 1 if is_straggler else 0
                self._durations.append(dt)
                if len(self._durations) > 100:
                    self._durations.pop(0)
                self.history.append(StepStats(
                    step=step, loss=loss, duration_s=dt,
                    straggler=is_straggler))
                if strikes >= self.cfg.max_straggler_strikes:
                    # on a real cluster: request host replacement + restart
                    strikes = 0
                step += 1
                if step % self.cfg.ckpt_every == 0:
                    self.manager.save(step, self.to_host(state),
                                      {"loss": loss})
            except _InjectedFault:
                # crash-equivalent: lose in-memory state, restart from ckpt
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                state = None
                state, step = recover()
        self.manager.save(num_steps, self.to_host(state), {})
        self.manager.wait()
        return state, self.history


class _InjectedFault(RuntimeError):
    """Raised by test fault injectors to emulate a node crash."""


def make_fault_injector(fail_at_steps: Dict[int, int]):
    """fail_at_steps: {step: times_to_fail}. Mutates its own copy."""
    remaining = dict(fail_at_steps)

    def inject(step: int):
        if remaining.get(step, 0) > 0:
            remaining[step] -= 1
            raise _InjectedFault(f"injected fault at step {step}")
    return inject
