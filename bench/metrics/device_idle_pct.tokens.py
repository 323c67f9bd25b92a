"""`device_idle_pct` in the OLMo cells (`harness/readers.py`)."""
from bench.harness.readers import device_idle_pct as read  # noqa: F401
