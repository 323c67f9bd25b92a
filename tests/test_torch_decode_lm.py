"""The slice as a whole: in-flight decode serving in the port against the
JAX package, with the same weights.

The JAX model is built as `CIMDecodeLM.toy` builds it (the same key
schedule for the fp32 masters, the same programs per operating point),
its masters cross to the port as numpy through
`convert.decode_lm_from_numpy`, and both packages serve the same fixed
schedules: one operating point, then base/throughput/quality mixed.  The
token streams must be equal.  The digital float ops (RMS norm, softmax)
may differ from XLA's by an ulp, so what is compared is the greedy token
streams, not the hidden states; the CIM projections themselves are
bit-exact (tests/test_torch_segments.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import mapping as jmap
from repro.runtime import engine as jrt
from repro.runtime import program as jprog
from repro.runtime import scheduler as jsch
from repro_torch.convert import decode_lm_from_numpy
from repro_torch.runtime import scheduler as tsch

D, D_FF, DEPTH, VOCAB, HEADS, WINDOW = 48, 96, 2, 23, 4, 16
POINTS = {"throughput": (2, 1), "quality": ((4, 2), (4, 4), (2, 2), (4, 2))}
KEY = jax.random.PRNGKey(7)
_PAIR = {}


def _jax_programs(rs):
    (qi, qw), (oi, ow), (gi, gw), (zi, zw) = \
        (rs,) * 4 if isinstance(rs[0], int) else rs
    cfg = jrt.EngineConfig()
    return (
        jprog.SharedInputProgram.compile(
            D, (("q", D), ("k", D), ("v", D)), cfg, r_in=qi, r_w=qw),
        jprog.compile_program(
            (jmap.LayerSpec(m=8, k=D, n=D, r_in=oi, r_w=ow),), cfg,
            activations=("none",)),
        jprog.SharedInputProgram.compile(
            D, (("gate", D_FF), ("up", D_FF)), cfg, r_in=gi, r_w=gw),
        jprog.compile_program(
            (jmap.LayerSpec(m=8, k=D_FF, n=D, r_in=zi, r_w=zw),), cfg,
            activations=("none",)))


def _models():
    """(JAX model, port model) serving the same masters at every point."""
    if not _PAIR:
        qkv_p, o_p, gu_p, dn_p = base = _jax_programs((4, 2))
        masters = []
        for b in range(DEPTH):        # CIMDecodeLM.toy's key schedule
            kb = jax.random.fold_in(KEY, 100 + b)
            masters.append({
                "qkv": qkv_p.init_params(jax.random.fold_in(kb, 0)),
                "o": list(o_p.init_params(jax.random.fold_in(kb, 1))),
                "gate_up": gu_p.init_params(jax.random.fold_in(kb, 2)),
                "down": list(dn_p.init_params(jax.random.fold_in(kb, 3)))})
        embed = 0.25 * jax.random.normal(jax.random.fold_in(KEY, 1),
                                         (VOCAB, D), jnp.float32)

        def blocks(progs):
            q, o, g, z = progs
            return [jsch.DecodeBlock(qkv=q.bind(m["qkv"]), o=o.bind(m["o"]),
                                     gate_up=g.bind(m["gate_up"]),
                                     down=z.bind(m["down"]))
                    for m in masters]

        jmodel = jsch.CIMDecodeLM(
            embed, blocks(base), n_heads=HEADS, window=WINDOW,
            variants={n: blocks(_jax_programs(rs))
                      for n, rs in POINTS.items()})

        def np_layer(p):
            return {k: np.asarray(v) for k, v in p.items()}

        tblocks = [{"q": np_layer(m["qkv"]["q"]), "k": np_layer(m["qkv"]["k"]),
                    "v": np_layer(m["qkv"]["v"]), "o": np_layer(m["o"][0]),
                    "gate": np_layer(m["gate_up"]["gate"]),
                    "up": np_layer(m["gate_up"]["up"]),
                    "down": np_layer(m["down"][0])} for m in masters]
        tmodel = decode_lm_from_numpy(np.asarray(embed), tblocks,
                                      n_heads=HEADS, window=WINDOW,
                                      points=POINTS, device="cpu")
        _PAIR["models"] = (jmodel, tmodel)
    return _PAIR["models"]


def _arrivals(seed, n_req, points):
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n_req):
        prompt = tuple(int(t) for t in
                       rng.integers(0, VOCAB, size=int(rng.integers(1, 5))))
        out.append((int(rng.integers(0, 7)), uid, prompt,
                    int(rng.integers(1, 6)), points[uid % len(points)]))
    return out


@pytest.mark.parametrize("seed,n_req,capacity,points", [
    (3, 5, 4, ("",)),
    (4, 6, 3, ("", "throughput", "quality")),
])
def test_port_token_streams_equal_jax(seed, n_req, capacity, points):
    jmodel, tmodel = _models()
    sched = _arrivals(seed, n_req, points)
    jout = jsch.InflightScheduler(jmodel, capacity=capacity).run(
        [(t, jsch.Request(u, p, n, pt)) for t, u, p, n, pt in sched])
    tsched = tsch.InflightScheduler(tmodel, capacity=capacity)
    tout = tsched.run(
        [(t, tsch.Request(u, p, n, pt)) for t, u, p, n, pt in sched])
    assert tout == jout
    assert sum(len(v) for v in tout.values()) == sum(n for *_, n, _ in sched)
    # the port's own isolation holds on the carried weights too
    for t, u, p, n, pt in sched:
        assert tsch.decode_sequential(tmodel, tsch.Request(u, p, n, pt)) \
            == tout[u]


def test_noise_identities_match_jax():
    for uid, call in ((0, 0), (3, 7), (5000, 2)):
        assert tsch.CIMDecodeLM.noise_id(uid, call) == \
            jsch.CIMDecodeLM.noise_id(uid, call)
    ids = np.array([0, 7, 2 ** 31 - 1, 123456789], np.int32)
    for proj in (0, 5, 63):
        np.testing.assert_array_equal(
            np.asarray(jsch.CIMDecodeLM._proj_ids(jnp.asarray(ids), proj)),
            tsch.CIMDecodeLM._proj_ids(ids, proj).numpy())
    assert tsch.CIMDecodeLM._proj_ids(None, 1) is None


def test_model_geometry_matches_jax():
    jmodel, tmodel = _models()
    assert (tmodel.d, tmodel.vocab, tmodel.depth, tmodel.points) == \
        (jmodel.d, jmodel.vocab, jmodel.depth, jmodel.points)
    for pt in tmodel.points:
        for jb, tb in zip(jmodel.blocks_for(pt), tmodel.blocks_for(pt)):
            for name in ("qkv", "o", "gate_up", "down"):
                jp = getattr(jb, name).program.plan
                tp = getattr(tb, name).program.plan
                assert jp.total_macro_evals == tp.total_macro_evals
                assert [lp.spec.k for lp in jp.layers] == \
                    [lp.spec.k for lp in tp.layers]
