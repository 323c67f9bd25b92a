"""`glue_device_pct` in the OLMo cells (`harness/readers.py`)."""
from bench.harness.readers import glue_device_pct as read  # noqa: F401
