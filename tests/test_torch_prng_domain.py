"""The port's float chain of a normal against JAX's own, bit for bit, on
every input it can have.

`jax.random.normal` reads only the top 23 bits of each 32-bit word
(`bits >> 9` makes its uniform), so a normal comes from one of 2^23
patterns `m << 9`.  JAX is fed exactly those patterns through a PRNG
implementation whose `random_bits` returns them
(`jax.extend.random.define_prng_impl`); the port's plain transform
`core/prng._normal_from_bits` takes the same patterns.  Equal on all of
them, the port equals JAX on every normal it can draw, and the CUDA draw
kernel, held to the same plain transform on all 2^23 patterns on the
card (`chip_smoke.py`, `tests/test_torch_gpu.py`), may leave out code no
pattern reaches.  Eight cases of 2^20 patterns each, one intra-op
thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import define_prng_impl

from repro_torch.core import prng

CHUNK = 1 << 20
CHUNKS = (1 << 23) // CHUNK


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it (test_torch_prng.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patterns(key, bit_width, shape):
    """random_bits of the pattern PRNG: key (chunk, 0) gives the patterns
    (chunk * CHUNK + i) << 9, i over the draw's elements in order."""
    assert bit_width == 32
    base = key[0].astype(jnp.uint32) * jnp.uint32(CHUNK)
    m = base + jax.lax.iota(jnp.uint32, int(np.prod(shape)))
    return (m << 9).reshape(shape)


_IMPL = define_prng_impl(
    key_shape=(2,),
    seed=lambda s: jnp.stack([s.astype(jnp.uint32), jnp.uint32(0)]),
    split=lambda k, shape: jnp.broadcast_to(k, (*shape, 2)),
    random_bits=_patterns, fold_in=lambda k, d: k, name="patterns")


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_normal_from_bits_equals_jax_on_every_pattern(chunk):
    key = jax.random.wrap_key_data(jnp.array([chunk, 0], jnp.uint32),
                                   impl=_IMPL)
    want = np.asarray(jax.random.normal(key, (CHUNK,), jnp.float32))
    bits = (torch.arange(CHUNK, dtype=torch.int64) + chunk * CHUNK) << 9
    # the pattern PRNG hands JAX the patterns themselves
    assert np.array_equal(np.asarray(_patterns(
        jnp.array([chunk, 0], jnp.uint32), 32, (CHUNK,))),
        bits.numpy().astype(np.uint32))
    got = prng._normal_from_bits(bits).numpy()
    same = want.view(np.int32) == got.view(np.int32)
    assert same.all(), (chunk, np.flatnonzero(~same)[:5])
