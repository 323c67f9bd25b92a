"""`eager_dispatch_pct` in the clean LeNet cell (`harness/readers.py`)."""
from bench.harness.readers import eager_dispatch_pct as read  # noqa: F401
