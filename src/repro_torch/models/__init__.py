"""The paper's own workloads."""
