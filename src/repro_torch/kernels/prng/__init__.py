"""The draw kernel: JAX's threefry normals, one stream per key."""
