"""Median host milliseconds from handing a call to the compiled program
to its return, before the wait for the device (the benchmark's
"serve" span)."""
import statistics


def read(ctx):
    d = ctx.spans.durations("serve")
    return 1e3 * statistics.median(d) if d else None
