"""The yardstick's frozen cost table and peaks (see costs.py)."""
