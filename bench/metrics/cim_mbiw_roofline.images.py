"""`cim_mbiw_roofline` in the clean LeNet cell (`harness/readers.py`)."""
from bench.harness.readers import cim_mbiw_roofline as read  # noqa: F401
