"""Attention kernels: ring-buffer decode attention (the in-flight decode
step) and flash attention forward and backward (the cache-free training
forward)."""
