"""Live slots over all slots of the window's fused decode steps, percent
(`harness/program_spans.py`)."""
from bench.harness.program_spans import slot_occupancy_pct


def read(ctx):
    return slot_occupancy_pct(ctx)
