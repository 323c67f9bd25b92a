"""`mfu` in the clean LeNet cell (`harness/readers.py`)."""
from bench.harness.readers import mfu as read  # noqa: F401
