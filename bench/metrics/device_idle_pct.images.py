"""`device_idle_pct` in the clean LeNet cell (`harness/readers.py`)."""
from bench.harness.readers import device_idle_pct as read  # noqa: F401
