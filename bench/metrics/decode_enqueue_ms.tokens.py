"""Median host milliseconds a fused decode step takes to enqueue its
forward, before the wait for its tokens (the program's "serve.enqueue"
spans in the window); beside `decode_step_ms.tokens` it says how
host-bound a step is."""
from bench.harness.program_spans import median_ms


def read(ctx):
    return median_ms(ctx, "serve.enqueue")
