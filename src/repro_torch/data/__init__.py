"""Datasets (procedural, numpy only)."""
