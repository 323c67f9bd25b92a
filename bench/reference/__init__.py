"""The plain reference the benchmark holds the port to.

Plain PyTorch, written from the published equations of the IMAGINE macro
and of OLMo: it imports neither JAX, the JAX package nor anything of the
port, and it is given only what the benchmark made (raw weights, images,
token ids).  Everything the program derives from those (quantized
weights, gains, offsets, caches) it works out again itself.
"""
