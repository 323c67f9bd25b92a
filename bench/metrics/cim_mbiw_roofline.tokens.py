"""`cim_mbiw_roofline` in the OLMo cells (`harness/readers.py`)."""
from bench.harness.readers import cim_mbiw_roofline as read  # noqa: F401
