"""Median host milliseconds of the compiled program's own graph-replayed
dispatch, canonicalize to clone, before the wait for the device (the
program's "program.dispatch" spans of route "replay" in the window)."""
from bench.harness.program_spans import median_ms


def read(ctx):
    return median_ms(ctx, "program.dispatch", route="replay")
