"""`glue_device_pct` in the clean LeNet cell (`harness/readers.py`)."""
from bench.harness.readers import glue_device_pct as read  # noqa: F401
