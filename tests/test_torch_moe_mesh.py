"""`moe_block` under a mesh folded onto one device
(`repro_torch/models/moe.py`: `mesh_split`, `_moe_folded`) against the
JAX package's shard_map body (`repro/models/moe.py:279-313`) run without
devices: JAX's own `_moe_local` on each shard's slices with
`psum_axis=None`, the model parts summed in numpy - the tokens split in
contiguous parts over "data" where b*s divides, w_gate / w_up split on
axis 2 and w_down on axis 1 over "model", the ABN tensors and the key
given whole to every shard.

What is held, and to what:

- meshes data 2 x model 2, data 1 x model 2 and data 2 x model 1, in
  bypass and fakequant, float32, without a key and with one (in fakequant
  with the noise model on, at data 2 x model 2, JAX run op by op under
  `jax.disable_jit()` with float32 noise leaves, as
  `tests/test_torch_moe.py` runs the noisy expert GEMM): within 2e-5 of
  the largest output, the tolerance
  `tests/test_torch_moe.py` states for `moe_block`, with JAX's top_idx;
- bit for bit where `tests/test_torch_moe.py` holds the unsharded path so:
  the fakequant expert GEMM of one model part of w_down (its K rows
  split, so its own fan-in, code gain and ADC) against jitted JAX, clean
  and noisy; and the folded block against the port's own `_moe_local`
  per shard summed in order (a two-term sum does not depend on order);
- where the mesh splits nothing (a 1 x 1 mesh; data 2 on an odd token
  count, as single-token decode), equal to the port's unsharded path;
- the sharded result is not the unsharded one where capacity drops
  tokens (each shard's capacity comes from its own token count);
- a mesh across devices raises NotImplementedError; engine mode runs the
  local path under any mesh;
- in a subprocess with `XLA_FLAGS=--xla_force_host_platform_device_count=4`
  the numpy emulation equals JAX's real shard_map at data 2 x model 2.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise_model as jnm
from repro.core.cim_layers import CIMConfig as JCIM
from repro.models import moe as jm
from repro_torch import convert
from repro_torch.core import noise_model as tnm
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tm
from repro_torch.models import sharding as tsh

E, D, F_, K = 4, 16, 48, 2
MESHES = [(2, 2), (1, 2), (2, 1)]
CF = 1.25


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module (test_torch_moe.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return np.asarray(a, np.float32).view(np.int32)


def _jax_bank(seed=5):
    p = jax.tree.map(np.array, jm.init_moe(jax.random.PRNGKey(seed), D,
                                             F_, E))
    rng = np.random.default_rng(seed)
    # learned ABN on the down projection, so its per-part ADC matters
    p["abn_log_gamma"] = rng.uniform(-1, 3, (E, D)).astype(np.float32)
    p["abn_beta"] = rng.uniform(-2, 2, (E, D)).astype(np.float32)
    return p


def _x(seed=6, shape=(2, 8, D)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _f32_leaves(noise):
    return noise.replace(**{f: jnp.float32(getattr(noise, f))
                            for f in tnm.LEAF_FIELDS})


def _configs(mode, noisy):
    if noisy:
        return (JCIM(mode=mode, r_in=8, r_w=4,
                     noise=_f32_leaves(jnm.NoiseConfig())),
                CIMConfig(mode=mode, r_in=8, r_w=4,
                          noise=tnm.NoiseConfig()))
    return JCIM(mode=mode, r_in=8, r_w=4), CIMConfig(mode=mode, r_in=8,
                                                     r_w=4)


def _jax_routing(jp, x):
    """moe_block's routing lines (`repro/models/moe.py:258-263`)."""
    xf = jnp.asarray(x.reshape(-1, D))
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], axis=-1)
    top_p, top_idx = jax.lax.top_k(probs, K)
    top_p = (top_p / jnp.sum(top_p, -1, keepdims=True)).astype(xf.dtype)
    return xf, top_p, top_idx


def _jax_shards(jp, x, jc, n_data, n_model, key=None):
    """JAX's shard_map body on each (token part, model part), psum_axis
    None, summed over the model parts in numpy; (out (b*s, D), top_idx)."""
    xf, top_p, top_idx = _jax_routing(jp, x)
    t = xf.shape[0]
    if t % n_data:
        n_data = 1
    fl = F_ // n_model
    kw = dict(n_experts=E, top_k=K, capacity_factor=CF, cim=jc, act="silu",
              psum_axis=None)
    rows = t // n_data
    outs = []
    for i in range(n_data):
        r = slice(i * rows, (i + 1) * rows)
        parts = []
        for j in range(n_model):
            c = slice(j * fl, (j + 1) * fl)
            args = (xf[r], top_p[r], top_idx[r], jp["w_gate"][:, :, c],
                    jp["w_up"][:, :, c], jp["w_down"][:, c, :],
                    jp["abn_log_gamma"], jp["abn_beta"], key)
            if key is None:
                parts.append(np.asarray(jax.jit(
                    lambda *a: jm._moe_local(*a, **kw))(*args[:-1])))
            else:
                with jax.disable_jit():
                    parts.append(np.asarray(jm._moe_local(*args, **kw)))
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        outs.append(out)
    return np.concatenate(outs), np.asarray(top_idx)


def _folded(shape):
    return tsh.use_mesh(tmesh.make_mesh(shape, ("data", "model"),
                                        fold_onto="cpu"))


def _port_block(jp, x, cim, shape=None, key=None):
    params = convert.moe_params_from_numpy(jp)
    kw = dict(n_experts=E, top_k=K, capacity_factor=CF, cim=cim, key=key)
    if shape is None:
        return tm.moe_block(params, torch.from_numpy(x), **kw)
    with _folded(shape):
        return tm.moe_block(params, torch.from_numpy(x), **kw)


# the noisy fakequant cases run JAX op by op (seconds each): data 2 x
# model 2 splits both ways and stands for the three meshes
CASES = ([(sh, k, m) for sh in MESHES for k in (False, True)
          for m in ("bypass", "fakequant") if not (k and m == "fakequant")]
         + [((2, 2), True, "fakequant")])


@pytest.mark.parametrize("shape,keyed,mode", CASES)
def test_folded_moe_block_matches_jax_shard_map_body(shape, keyed, mode):
    jp, x = _jax_bank(), _x()
    noisy = keyed and mode == "fakequant"
    jc, tc = _configs(mode, noisy)
    jkey = jax.random.PRNGKey(11) if keyed else None
    tkey = (convert.key_from_numpy(np.asarray(jkey)) if keyed else None)
    want, jidx = _jax_shards(jp, x, jc, *shape, key=jkey if noisy else None)
    got, aux = _port_block(jp, x, tc, shape, key=tkey)
    np.testing.assert_allclose(got.reshape(-1, D).numpy(), want, rtol=0,
                               atol=2e-5 * float(np.abs(want).max()))
    _, _, tidx = tm.route(torch.from_numpy(x.reshape(-1, D)),
                          torch.from_numpy(jp["router"]), E, K)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    # the same aux as the unsharded block: the router runs unsplit
    _, aux0 = _port_block(jp, x, tc, None, key=tkey)
    assert torch.equal(aux, aux0)


@pytest.mark.parametrize("mode", ["bypass", "fakequant"])
@pytest.mark.parametrize("shape", MESHES)
def test_folded_moe_block_is_the_port_body_per_shard(shape, mode):
    """The folded path is `_moe_local` per (token part, model part), the
    model parts summed in order, bit for bit."""
    jp, x = _jax_bank(), _x()
    _, tc = _configs(mode, False)
    got, _ = _port_block(jp, x, tc, shape)
    p = convert.moe_params_from_numpy(jp)
    xf = torch.from_numpy(x.reshape(-1, D))
    _, top_p, top_idx = tm.route(xf, p["router"], E, K)
    n_data, n_model = shape
    fl, rows = F_ // n_model, xf.shape[0] // n_data
    outs = []
    for i in range(n_data):
        r = slice(i * rows, (i + 1) * rows)
        out = None
        for j in range(n_model):
            c = slice(j * fl, (j + 1) * fl)
            part = tm._moe_local(
                xf[r], top_p[r], top_idx[r], p["w_gate"][:, :, c],
                p["w_up"][:, :, c], p["w_down"][:, c, :],
                p["abn_log_gamma"], p["abn_beta"], n_experts=E, top_k=K,
                capacity_factor=CF, cim=tc, act="silu")
            out = part if out is None else out + part
        outs.append(out)
    np.testing.assert_array_equal(_bits(got.reshape(-1, D)),
                                  _bits(torch.cat(outs)))


@pytest.mark.parametrize("noisy", [False, True])
def test_down_projection_part_matches_jax_bit_for_bit(noisy):
    """One model part of w_down (its K rows split: fan-in F / 2, its own
    code gain and ADC) through the fakequant expert GEMM, bit for bit
    against jitted JAX (noisy: against JAX op by op with float32 leaves)."""
    rng = np.random.default_rng(3)
    k_part = 1300                         # two macro row tiles a part
    h = rng.normal(size=(E, 8, 2 * k_part)).astype(np.float32)
    w = (rng.normal(size=(E, 2 * k_part, 20)) * k_part ** -0.5).astype(
        np.float32)
    lg = rng.uniform(-1, 3, (E, 20)).astype(np.float32)
    bt = rng.uniform(-2, 2, (E, 20)).astype(np.float32)
    jc, tc = _configs("fakequant", noisy)
    key = jax.random.PRNGKey(7)
    for j in range(2):
        c = slice(j * k_part, (j + 1) * k_part)
        args = [h[..., c], w[:, c, :], lg, bt]
        if noisy:
            with jax.disable_jit():
                want = jm._expert_gemm(*(jnp.asarray(a) for a in args[:2]),
                                       jc, (jnp.asarray(lg), jnp.asarray(bt)),
                                       key=key)
            tkey = convert.key_from_numpy(np.asarray(key))
        else:
            want = jax.jit(lambda x, w, l, b: jm._expert_gemm(
                x, w, jc, (l, b)))(*args)
            tkey = None
        tt = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
        got = tm._expert_gemm(tt[0], tt[1], tc, (tt[2], tt[3]), key=tkey)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("mode", ["bypass", "fakequant"])
def test_a_mesh_that_splits_nothing_is_the_unsharded_path(mode):
    jp = _jax_bank()
    _, tc = _configs(mode, False)
    x = _x()
    want, _ = _port_block(jp, x, tc)
    got, _ = _port_block(jp, x, tc, (1, 1))
    assert torch.equal(got, want)
    # 7 tokens do not split over data 2: the tokens stay whole
    x7 = _x(7, (1, 7, D))
    want, _ = _port_block(jp, x7, tc)
    got, _ = _port_block(jp, x7, tc, (2, 1))
    assert torch.equal(got, want)
    assert tm.mesh_split(7, tc) is None
    with _folded((2, 1)):
        assert tm.mesh_split(7, tc) == (1, 1)
        assert tm.mesh_split(8, tc) == (2, 1)


def test_each_shard_takes_its_own_capacity():
    """With drops (capacity factor 0.5) the data-split block differs from
    the unsharded one, as JAX's sharded path does: a shard's capacity is
    computed from its local token count."""
    jp, x = _jax_bank(), _x(8, (8, 16, D))
    _, tc = _configs("bypass", False)
    params = convert.moe_params_from_numpy(jp)
    kw = dict(n_experts=E, top_k=K, capacity_factor=0.5, cim=tc)
    want, _ = tm.moe_block(params, torch.from_numpy(x), **kw)
    with _folded((2, 1)):
        got, _ = tm.moe_block(params, torch.from_numpy(x), **kw)
    assert not torch.equal(got, want)
    assert tm.capacity(128, E, K, 0.5) != tm.capacity(64, E, K, 0.5)


def test_a_mesh_across_devices_raises_and_engine_runs_local():
    jp, x = _jax_bank(), _x()
    _, tc = _configs("fakequant", False)
    params = convert.moe_params_from_numpy(jp)
    across = tmesh.DeviceMesh(
        devices=(torch.device("cuda", 0), torch.device("cuda", 1)),
        shape=(1, 2), axis_names=("data", "model"))
    with tsh.use_mesh(across):
        with pytest.raises(NotImplementedError, match="across"):
            tm.moe_block(params, torch.from_numpy(x), n_experts=E,
                         top_k=K, capacity_factor=CF, cim=tc)
        assert tm.mesh_split(16, tc.replace(mode="engine")) is None


SUBPROCESS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, numpy as np
    sys.path.insert(0, {tests!r})
    import test_torch_moe_mesh as t
    from repro.jax_compat import set_mesh
    from repro.models import moe as jm
    assert len(jax.devices()) == 4, jax.devices()
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    for mode in ("bypass", "fakequant"):
        jp, x = t._jax_bank(), t._x()
        jc, _ = t._configs(mode, False)
        with set_mesh(mesh):
            got, _ = jax.jit(lambda p, x: jm.moe_block(
                p, x, n_experts=t.E, top_k=t.K, capacity_factor=t.CF,
                cim=jc))(jp, x)
        want, _ = t._jax_shards(jp, x, jc, 2, 2)
        got = np.asarray(got).reshape(-1, t.D)
        err = float(np.abs(got - want).max())
        print(mode, err, flush=True)
        assert err <= 2e-5 * float(np.abs(want).max()), (mode, err)
    print("OK")
""")


def test_emulation_equals_jax_shard_map_on_four_host_devices():
    """JAX's real shard_map at data 2 x model 2 on four faked host
    devices equals this file's numpy emulation of its body."""
    tests = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(tests), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c",
                          SUBPROCESS.format(tests=tests)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, \
        out.stdout + out.stderr[-3000:]
