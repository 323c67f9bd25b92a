"""Median host milliseconds of a request's solo prefill, from the batch-1
cache to its first token on the host (the program's "serve.prefill"
spans in the window)."""
from bench.harness.program_spans import median_ms


def read(ctx):
    return median_ms(ctx, "serve.prefill")
