"""Host seconds of set-up's CUDA graph captures (`engine.CAPTURE_COUNT`)
as a share of set-up, percent (`harness/program_spans.py`)."""
from bench.harness.program_spans import setup_pct


def read(ctx):
    return setup_pct(ctx, "CAPTURE_COUNT")
