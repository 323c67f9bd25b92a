"""Hand-written Hopper kernels and the nvcc build that loads them."""
