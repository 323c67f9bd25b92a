"""`mfu` in the OLMo cells (`harness/readers.py`)."""
from bench.harness.readers import mfu as read  # noqa: F401
