"""Attention kernels: ring-buffer decode attention (the in-flight decode
step); the flash forward and backward kernels are not ported yet."""
