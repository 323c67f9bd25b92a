"""PyTorch / CUDA port of the IMAGINE CIM accelerator reproduction.

A package beside the JAX reference (`repro`), module for module: each
`repro_torch.X` is held bit for bit against `repro.X` by the tests
`tests/test_torch_*.py`.  Plain tensor code is PyTorch; the TPU's Pallas
kernels become hand-written Hopper kernels (`kernels/*/csrc/*.cu`, built
by `kernels/build.py` at first use).  Entry points run on CUDA unless the
caller asks for the CPU, where the kernels' plain versions run.
"""
