"""`eager_dispatch_pct` in the OLMo cells (`harness/readers.py`)."""
from bench.harness.readers import eager_dispatch_pct as read  # noqa: F401
