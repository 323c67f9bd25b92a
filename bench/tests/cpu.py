"""Drive a cell's run on the CPU at a tiny size: the harness's look for a
card skipped, the program on its plain kernels."""
from __future__ import annotations

import dataclasses
import time

import torch

from bench.harness import manifest
from bench.harness.context import Context


def tiny_cell(name: str, config: dict = None, traffic: dict = None):
    """The cell `name` with keys of its configuration and traffic
    replaced."""
    cell = manifest.cell(name)
    return dataclasses.replace(cell, config={**cell.config, **(config or {})},
                               traffic={**cell.traffic, **(traffic or {})})


def run_cpu(cell, seed: int = 7, seconds: float = 0.0, tracing=False,
            control=False) -> Context:
    """One run of `cell` on the CPU; returns its filled context."""
    ctx = Context(cell=cell, seed=seed, seconds=seconds, tracing=tracing,
                  device=torch.device("cpu"), t_start=time.perf_counter(),
                  control=control)
    manifest.kind_module(cell.kind).run(ctx)
    return ctx
