"""The port's cimcheck against the JAX package's, contract by contract.

Each of the 24 contracts of `tests/test_cimcheck.py` holds here for
`repro_torch.analysis`, and where both packages can run the same seeded
input, the port's codes equal JAX's.  Beyond them: the port's fold chains
equal JAX's `enumerate_fold_tuples` and the keys `engine._stream_keys`
folds; every PV code on a seeded plan; the SASS pass on listings that
`cuobjdump -sass` (CUDA 12.9) printed for libraries built with
`kernels/build.py`'s flags on an H100; the zoo sweep and its CLI; a check
leaves no trace in the caches; the barrier's marker costs the eager path
no operator; and the legacy entry points bit for bit against JAX's.
Sizes are small and the module runs on one intra-op thread.
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import analysis as ja
from repro.analysis import noise_keys as jnk
from repro.analysis import plan_checks as jpc
from repro.analysis import recompile as jrc
from repro.core import mapping as jmap
from repro.core import noise_model as jnm
from repro.core import quantization as jq
from repro.runtime import engine as jrt
from repro.runtime import program as jprog
from repro_torch import analysis as ta
from repro_torch.analysis import __main__ as tcli
from repro_torch.analysis import graph_walk as gw
from repro_torch.analysis import noise_keys as tnk
from repro_torch.analysis import plan_checks as tpc
from repro_torch.analysis import recompile as trc
from repro_torch.analysis import sass
from repro_torch.convert import params_from_numpy
from repro_torch.core import mapping as tmap
from repro_torch.core import noise_model as tnm
from repro_torch.core import prng
from repro_torch.core import quantization as tq
from repro_torch.kernels.cim_mbiw import kernel as kmod
from repro_torch.runtime import engine as trt
from repro_torch.runtime import program as tprog


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: its traces run thousands of tiny CPU ops, and where pytest-xdist
    workers share the cores PyTorch's pool spins at each op's barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JX = jnp.ones((8,), jnp.float32)
_JG = jnp.full((8,), 1.5, jnp.float32)
_JB = jnp.zeros((8,), jnp.float32)
_TX = torch.ones(8)
_TG = torch.full((8,), 1.5)
_TB = torch.zeros(8)


def _both(tfn, jfn, t_args, j_args):
    """(port codes, JAX codes) of one linted function."""
    return (ta.lint_callable(tfn, *t_args).codes(),
            ja.lint_callable(jfn, *j_args).codes())


def _dense_pair(r_in=4, r_w=2, noise=False):
    specs = dict(m=8, k=64, n=32, r_in=r_in, r_w=r_w)
    jp = jprog.compile_program(
        [jmap.LayerSpec(**specs)],
        jrt.EngineConfig(noise=jnm.NoiseConfig(enabled=noise)))
    tp = tprog.compile_program(
        [tmap.LayerSpec(**specs)],
        trt.EngineConfig(noise=tnm.NoiseConfig(enabled=noise)),
        device="cpu")
    return jp, tp


def _plans(specs=(dict(m=8, k=64, n=32, r_in=4, r_w=2),)):
    return (jrt.plan_network([jmap.LayerSpec(**s) for s in specs],
                             jrt.EngineConfig()),
            trt.plan_network([tmap.LayerSpec(**s) for s in specs],
                             trt.EngineConfig()))


# ---------------------------------------------------------------------------
# barrier lint (contracts 1-5 and the port's NB003)
# ---------------------------------------------------------------------------

def test_barrier_lint_clean_on_real_quantizers():
    assert _both(
        lambda dp, g, b: tq.adc_quantize(dp, r_out=8, gain=g, beta_codes=b),
        lambda dp, g, b: jq.adc_quantize(dp, r_out=8, gain=g, beta_codes=b),
        (_TX, _TG, _TB), (_JX, _JG, _JB)) == ([], [])
    assert _both(lambda v: tq.quantize_act(v, 4),
                 lambda v: jq.quantize_act(v, 4), (_TX,), (_JX,)) == ([], [])
    assert _both(lambda v: tq.quantize_weight(v, 2),
                 lambda v: jq.quantize_weight(v, 2),
                 (torch.ones(8, 4),), (jnp.ones((8, 4)),)) == ([], [])


def test_barrier_lint_fires_on_stripped_barrier():
    """The ADC epilogue with its barrier stripped gives NB001 in both."""
    def bad(floor):
        return lambda dp, gain, beta: floor(2.0 ** 7 + gain * dp + beta)

    def good(floor, barrier):
        return lambda dp, gain, beta: floor(2.0 ** 7 + barrier(gain * dp)
                                            + beta)
    assert _both(bad(torch.floor), bad(jnp.floor), (_TX, _TG, _TB),
                 (_JX, _JG, _JB)) == (["NB001"], ["NB001"])
    assert _both(good(torch.floor, tq.rounding_barrier),
                 good(jnp.floor, jq.rounding_barrier), (_TX, _TG, _TB),
                 (_JX, _JG, _JB)) == ([], [])


def test_barrier_lint_fires_on_constant_divide():
    """NB002 on a non-power-of-two literal divisor, a Python scalar or a
    constant tensor (CUDA multiplies by the reciprocal of either)."""
    assert _both(lambda v: torch.round(v / 255.0),
                 lambda v: jnp.round(v / 255.0), (_TX,), (_JX,)) \
        == (["NB002"], ["NB002"])
    assert _both(lambda v: torch.round(v / 256.0),
                 lambda v: jnp.round(v / 256.0), (_TX,), (_JX,)) == ([], [])
    assert _both(lambda v, s: torch.round(v / s),
                 lambda v, s: jnp.round(v / s),
                 (_TX, torch.tensor(3.0)), (_JX, jnp.float32(3.0))) \
        == ([], [])
    assert ta.lint_callable(lambda v: torch.round(
        v / torch.tensor(255.0)), _TX).codes() == ["NB002"]


def test_barrier_lint_descends_into_ste_floor():
    assert _both(lambda dp, g: tq.ste_floor(g * dp + 8.0),
                 lambda dp, g: jq.ste_floor(g * dp + 8.0),
                 (_TX, _TG), (_JX, _JG)) == (["NB001"], ["NB001"])
    assert _both(
        lambda dp, g: tq.ste_floor(tq.rounding_barrier(g * dp) + 8.0),
        lambda dp, g: jq.ste_floor(jq.rounding_barrier(g * dp) + 8.0),
        (_TX, _TG), (_JX, _JG)) == ([], [])


class _FloorOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dp, g):
        return torch.floor(g * dp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def test_barrier_lint_through_jit_boundary():
    """JAX's jit boundary; the port's counterpart, an autograd Function,
    inlines into the recorded graph."""
    assert ta.lint_callable(_FloorOf.apply, _TX, _TG).codes() == ["NB001"]
    assert ja.lint_callable(jax.jit(lambda dp, g: jnp.floor(g * dp)),
                            _JX, _JG).codes() == ["NB001"]


@pytest.mark.parametrize("fn", [
    lambda a, b, c: torch.floor(torch.addcmul(a, b, c)),
    lambda a, b, c: torch.floor(torch.lerp(a, b, c)),
    lambda a, b, c: torch.round(torch.add(a, b, alpha=3.0)),
    lambda a, b, c: torch.floor(torch.addmm(a[:2, None].expand(2, 2),
                                            b.reshape(2, 4),
                                            c.reshape(4, 2))),
], ids=("addcmul", "lerp", "add_alpha", "addmm"))
def test_barrier_lint_flags_contracting_ops(fn):
    """NB003, the port's code: an aten op that rounds a product and a sum
    once on a rounding path."""
    assert ta.lint_callable(fn, _TX, _TG, _TB + 0.25).codes() == ["NB003"]


def test_barrier_marker_costs_the_eager_path_nothing():
    """Eagerly the barrier returns its operand and dispatches no op; under
    a lint trace it leaves one aten.alias node."""
    seen = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))
    x = torch.randn(5)
    with Count():
        y = tq.rounding_barrier(x)
    assert y is x and seen == []
    g = gw.trace(lambda v: tq.rounding_barrier(v * 2.0), x)
    assert [gw.op_name(n) for n in g.nodes
            if n.op == "call_function"] == ["mul", "alias"]


# ---------------------------------------------------------------------------
# the SASS pass (contract 6: the post-compiler check)
# ---------------------------------------------------------------------------

# cuobjdump -sass of three kernels built with kernels/build.py's flags for
# sm_90a (trimmed): `pred` floors a predicated fma, `clean_rn` is the
# contract's chain (__fmul_rn / __fadd_rn), `seeded_float` the chain with
# plain operators, which nvcc fuses into one FFMA
_SEEDED_SASS = r"""
        code for sm_90a
                Function : pred
        /*0070*/               @P0 EXIT ;                                    /* 0x000000000000094d */
        /*0080*/                   ULDC UR4, c[0x0][0x23c] ;                 /* 0x00008f0000047ab9 */
        /*0090*/                   LDC.64 R2, c[0x0][0x220] ;
        /*00a0*/                   ISETP.NE.AND P0, PT, RZ, UR4, PT ;
        /*00b0*/                   ULDC.64 UR4, c[0x0][0x208] ;
        /*00c0*/                   SHF.R.S32.HI R8, RZ, 0x1f, R9 ;
        /*00e0*/               @P0 LDC.64 R4, c[0x0][0x218] ;
        /*00f0*/               @P0 IMAD.SHL.U32 R7, R9.reuse, 0x4, RZ ;
        /*0110*/               @P0 LDC.64 R10, c[0x0][0x210] ;
        /*0120*/                   IMAD.WIDE R2, R9, 0x4, R2 ;
        /*0130*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0170*/               @P0 LDG.E R4, desc[UR4][R4.64] ;
        /*0190*/               @P0 LDC R11, c[0x0][0x228] ;
        /*01a0*/               @P0 LDG.E R7, desc[UR4][R6.64] ;
        /*01b0*/               @P0 I2FP.F32.S32 R0, R4 ;
        /*01c0*/               @P0 FFMA R0, R0, R7, R11 ;                    /* 0x0000000700000223 */
        /*01d0*/              @!P0 IMAD.MOV.U32 R0, RZ, RZ, R2 ;             /* 0x000000ffff008224 */
        /*01e0*/                   FADD R0, R2, R0 ;                         /* 0x0000000002007221 */
        /*01f0*/                   F2I.FLOOR.NTZ R11, R0 ;                   /* 0x00000000000b7305 */
        /*0220*/                   STG.E desc[UR4][R2.64], R11 ;
        /*0230*/                   EXIT ;
        /*0240*/                   BRA 0x240;
                Function : clean_rn
        /*00f0*/                   LDG.E R4, desc[UR4][R4.64] ;
        /*0100*/                   IMAD.WIDE R2, R11, 0x4, R2 ;
        /*0110*/                   LDG.E R3, desc[UR4][R2.64] ;
        /*0120*/                   IMAD.WIDE R6, R11, 0x4, R6 ;
        /*0130*/                   LDG.E R7, desc[UR4][R6.64] ;
        /*0140*/                   I2FP.F32.S32 R0, R4 ;
        /*0150*/                   FMUL R0, R0, R3 ;
        /*0160*/                   FADD R0, R0, UR6 ;
        /*0170*/                   FADD R0, R0, R7 ;
        /*0180*/                   FRND.FLOOR R0, R0 ;
        /*0190*/                   FMNMX R4, RZ, R0, !PT ;
        /*01a0*/                   FMNMX R4, R4, 255, PT ;
        /*01b0*/                   F2I.TRUNC.NTZ R5, R4 ;
        /*01d0*/                   STG.E desc[UR4][R2.64], R5 ;
        /*01e0*/                   EXIT ;
        /*01f0*/                   BRA 0x1f0;
                Function : seeded_float
        /*00f0*/                   LDG.E R4, desc[UR4][R4.64] ;
        /*0110*/                   LDG.E R3, desc[UR4][R2.64] ;
        /*0130*/                   LDG.E R7, desc[UR4][R6.64] ;
        /*0140*/                   I2FP.F32.S32 R0, R4 ;
        /*0150*/                   FFMA R0, R0, R3, UR6 ;
        /*0160*/                   FADD R0, R0, R7 ;
        /*0170*/                   FRND.FLOOR R0, R0 ;
        /*0190*/                   FMNMX R10, RZ, R0, !PT ;
        /*01a0*/                   FMNMX R9, R10, 255, PT ;
        /*01b0*/                   STG.E desc[UR4][R4.64], R9 ;
        /*01c0*/                   EXIT ;
        /*01d0*/                   BRA 0x1d0;
"""

# the ADC epilogue of cim_mbiw_splitk.cu as the card runs it: one block
# from a BSSY reconvergence point to the floor (gain = gamma * g0 in
# UR40, mid in UR41, beta loaded into R16)
_SPLITK_SASS = r"""
        Function : _ZN51_GLOBAL__N__c757c8e5_18_cim_mbiw_splitk_cu_5c2eea0822cim_mbiw_splitk_kernelEPKaS1_PKfS3_PiS4_PjiiiiiiN3cim3AdcEii
        /*49b0*/                   BSSY B2, 0x4c00 ;                                          /* 0x0000024000027945 */
        /*49c0*/                   LEA.HI R9, R9, R2, RZ, 0x6 ;
        /*49d0*/                   ISETP.NE.AND P2, PT, R5, RZ, PT ;
        /*4a00*/                   ISETP.GE.AND P1, PT, R12, R4, PT ;
        /*4a10*/               @P1 BRA 0x4bf0 ;
        /*4a20*/                   SHF.R.S32.HI R9, RZ, 0x6, R9 ;
        /*4a60*/                   IMAD.WIDE.U32 R10, R9, R4, R12 ;
        /*4a80*/                   IMAD.SHL.U32 R9, R10, 0x4, RZ ;
        /*4aa0*/                   IMAD.WIDE R12, R12, 0x4, R6 ;
        /*4ab0*/                   IADD3 R14, P1, R9, UR6, RZ ;
        /*4ad0*/                   LDG.E.CONSTANT R12, desc[UR8][R12.64] ;
        /*4ae0*/                   IADD3.X R15, R10, UR7, RZ, P1, !PT ;
        /*4af0*/                   ATOMG.E.EXCH.STRONG.GPU PT, R14, desc[UR8][R14.64], RZ ;
        /*4b00*/                   IADD3 R16, P1, R9, UR48, RZ ;
        /*4b10*/                   IADD3.X R17, R10, UR49, RZ, P1, !PT ;
        /*4b20*/                   LDG.E.CONSTANT R16, desc[UR8][R16.64] ;
        /*4b30*/                   FMUL R11, R12, UR40 ;                                      /* 0x000000280c0b7c20 */
        /*4b40*/                   I2FP.F32.S32 R18, R14 ;
        /*4b50*/                   FMUL R11, R11, R18 ;
        /*4b60*/                   FADD R11, R11, UR41 ;
        /*4b70*/                   FADD R11, R11, R16 ;
        /*4b80*/                   FRND.FLOOR R11, R11 ;
        /*4b90*/                   IADD3 R12, P1, R9, UR24, RZ ;
        /*4ba0*/                   FMNMX R14, RZ, R11, !PT ;
        /*4bb0*/                   FMNMX R14, R14, UR52, PT ;
"""


def test_sass_pass_on_captured_listings():
    """The post-compiler counterpart of JAX's NB101 check: the pass finds
    the FFMA on each seeded floor's slice (through a predicated move in
    `pred`) and none in the contract's chain or the split-K epilogue."""
    rep = sass.lint_sass(_SEEDED_SASS, library="seeded")
    per = {f.function: (f.sinks, f.ffma_on_slice, f.ffma_total)
           for f in rep.functions}
    assert per == {"pred": (1, 1, 1), "clean_rn": (1, 0, 0),
                   "seeded_float": (1, 1, 1)}
    assert [f.code for f in rep.findings] == ["NB102", "NB102"]
    assert {f.where for f in rep.findings} == {"seeded:pred",
                                               "seeded:seeded_float"}
    merged = ta.Report()
    merged.extend(rep.findings)
    assert merged.codes() == ["NB102", "NB102"] and not merged.ok()
    real = sass.lint_sass(_SPLITK_SASS, library="cim_mbiw_splitk")
    assert real.totals() == {"functions": 1, "sinks": 1, "ffma_on_slice": 0}
    assert real.findings == []


@pytest.mark.parametrize("line,hit", [
    ("FMUL R11, R11, R18 ;", True),        # gain * dp fused into ...
    ("FADD R11, R11, UR41 ;", True),       # ... the sum with mid
    ("FMUL R11, R12, UR40 ;", True),       # gain itself
    ("IADD3 R12, P1, R9, UR24, RZ ;", False),   # after the floor
])
def test_sass_pass_sees_a_seeded_ffma_in_the_splitk_epilogue(line, hit):
    """Mutation check on the real epilogue: turn one op into an FFMA (the
    sum with beta stays as it is) and the pass reports it exactly when
    it lies on the floor's slice."""
    op = line.split()[0]
    mutated = _SPLITK_SASS.replace(line, line.replace(op, "FFMA", 1)
                                   .replace(" ;", ", RZ ;"), 1)
    assert mutated != _SPLITK_SASS
    rep = sass.lint_sass(mutated)
    assert rep.totals()["ffma_on_slice"] == int(hit)
    assert [f.code for f in rep.findings] == (["NB102"] if hit else [])


def test_sass_pass_stops_at_join_points():
    """A definition before a branch target never reaches past it: the
    fma above the BSSY's reconvergence point is off the slice."""
    text = """Function : k
        /*0000*/ FFMA R0, R1, R2, R3 ;
        /*0010*/ BSSY B0, 0x30 ;
        /*0020*/ @P0 BRA 0x30 ;
        /*0030*/ FADD R0, R0, R4 ;
        /*0040*/ FRND.FLOOR R5, R0 ;
    """
    assert sass.lint_sass(text).totals()["ffma_on_slice"] == 0
    straight = text.replace("BSSY B0, 0x30", "NOP").replace(
        "@P0 BRA 0x30", "NOP")
    assert sass.lint_sass(straight).totals()["ffma_on_slice"] == 1


def test_sass_pass_raises_without_its_inputs(monkeypatch, tmp_path):
    """Without a listing, a built library or cuobjdump, the pass raises
    with the reason instead of reporting clean."""
    with pytest.raises(ValueError, match="no SASS function"):
        sass.lint_sass("nothing here")
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "_BUILT", {})
    with pytest.raises(RuntimeError, match="was not built"):
        sass.lint_library("cim_mbiw")
    monkeypatch.setattr(build, "nvcc_path",
                        lambda: str(tmp_path / "bin" / "nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        sass.cuobjdump_path()
    with pytest.raises(RuntimeError, match="no built library"):
        sass.disassemble(tmp_path / "missing.so")


# ---------------------------------------------------------------------------
# noise-key injectivity (contracts 7-11)
# ---------------------------------------------------------------------------

def test_noise_chains_clean_on_plan():
    jplan, tplan = _plans()
    assert tnk.check_injectivity(tplan, 8) == []
    assert jnk.check_injectivity(jplan, 8) == []
    chains = tnk.enumerate_fold_tuples(tplan, 300)
    assert len(chains) == len(set(chains))
    assert any(len(c) == 2 for c in chains)
    assert any(c[-1] == 2 for c in chains if len(c) == 5)


@pytest.mark.parametrize("specs,m,ids,sub", [
    ((dict(m=8, k=64, n=32, r_in=4, r_w=2),), 300, None, None),
    ((dict(m=4, k=2304, n=80, r_in=8, r_w=4),
      dict(m=4, k=80, n=10, r_in=8, r_w=4)), 129, None, None),
    ((dict(m=4, k=2304, n=80, r_in=8, r_w=4),), 3, [5, 1 << 20, 9],
     [0, 1, 2]),
], ids=("dense_m300", "two_layers_multi_tile", "identity"))
def test_fold_tuples_equal_jax(specs, m, ids, sub):
    """The port enumerates the chains JAX enumerates, in its order."""
    jplan, tplan = _plans(specs)
    assert tnk.enumerate_fold_tuples(tplan, m, noise_ids=ids, row_sub=sub) \
        == jnk.enumerate_fold_tuples(jplan, m, noise_ids=ids, row_sub=sub)


@pytest.mark.parametrize("identity", (False, True))
def test_fold_chains_are_what_stream_keys_folds(identity):
    """Folding each enumerated chain onto a layer key gives the keys
    `engine._stream_keys` draws under, one for one."""
    _, tplan = _plans((dict(m=4, k=2304, n=80, r_in=8, r_w=4),))
    lp = tplan.layers[0]
    lkey = prng.fold_in_int(prng.key_ints(prng.key(7)), 0)
    m = 300 if not identity else 3
    ids = torch.tensor([4, 7, 7]) if identity else None
    sub = torch.tensor([0, 0, 1]) if identity else None
    keys, _ = trt._stream_keys(lkey, len(lp.k_slices), len(lp.n_slices), m,
                               ids, sub)
    chains = tnk.stream_chains(
        lp, m, noise_ids=None if ids is None else ids.tolist(),
        row_sub=None if sub is None else sub.tolist())
    want = []
    for chain in chains:
        k = lkey
        for v in chain:
            k = prng.fold_in_int(k, v)
        want.append(k)
    assert keys.tolist() == [list(k) for k in want]


def test_duplicate_noise_id_detected():
    jplan, tplan = _plans()
    ids = [100, 101, 100, 102]
    got = tnk.check_injectivity(tplan, 4, noise_ids=ids)
    assert {f.code for f in got} == {"NK001", "NK002"}
    assert [f.code for f in got] == [
        f.code for f in jnk.check_injectivity(jplan, 4, noise_ids=ids)]
    assert tnk.check_injectivity(tplan, 4,
                                 noise_ids=[100, 101, 102, 103]) == []
    assert tnk.check_noise_ids([7, 7], row_sub=[0, 1]) == []


@pytest.mark.parametrize("requests", [
    [(0, 64), (1, 64), (2046, 64)], [(2048, 4)],
    [(0, tprog.NOISE_ID_STRIDE + 1)], [(3, 5), (3, 2)], [(-1, 1)],
])
def test_request_range_overlap_and_overflow(requests):
    got = [f.code for f in tnk.check_request_ranges(requests)]
    assert got == [f.code for f in jnk.check_request_ranges(requests)]
    assert ("NK004" in got) == any(i >= 2048 or i < 0 for i, _ in requests)


def test_request_noise_ids_validates_int32():
    ids = tprog.request_noise_ids(2047, 4)
    assert int(ids[0]) == 2047 * tprog.NOISE_ID_STRIDE
    assert ids.dtype == torch.int32
    assert np.array_equal(ids.numpy(),
                          np.asarray(jprog.request_noise_ids(2047, 4)))
    for args in ((2048, 1), (-1, 4), (0, 0), (2047, tprog.NOISE_ID_STRIDE + 1)):
        with pytest.raises(ValueError):
            tprog.request_noise_ids(*args)
        with pytest.raises(ValueError):
            jprog.request_noise_ids(*args)


@pytest.mark.parametrize("reqs,calls,want", [
    (4096, 8, ["NK005"]), (2048, 64, []), (2049, 1, ["NK005"]),
    (16, (1 << 20) + 1, ["NK005"]), (8192, (1 << 21), ["NK005", "NK005"]),
])
def test_scheduler_limit_warnings(reqs, calls, want):
    got = tnk.check_scheduler_limits(max_requests=reqs,
                                     max_calls_per_request=calls)
    assert [f.code for f in got] == want
    assert all(f.severity == ta.Severity.WARNING for f in got)
    assert [f.code for f in jnk.check_scheduler_limits(
        max_requests=reqs, max_calls_per_request=calls)] == want


# ---------------------------------------------------------------------------
# recompile hazards (contracts 12-15)
# ---------------------------------------------------------------------------

def test_reachable_key_set_bounded():
    jp, tp = _dense_pair()
    assert trc.run(tp, max_m=1024).findings == []
    keys = trc.reachable_keys(tp.buckets, 1024, devices=1,
                              noise_enabled=False)
    assert len(keys) == 8 * len(tp.buckets.ladder(1024))
    assert keys == jrc.reachable_keys(jp.buckets, 1024, devices=1,
                                      noise_enabled=False)
    keys3 = trc.reachable_keys(tp.buckets, 1024, devices=1,
                               noise_enabled=False,
                               points=("", "quality", "throughput"))
    assert len(keys3) == 3 * len(keys)
    assert trc.check_key_budget(
        tp.buckets, 1024, devices=1, noise_enabled=True,
        points=("", "quality", "balanced", "throughput")) == []
    # a bound program captures one graph a clean key: segmented or not,
    # at each rung
    assert len(trc.capturable_keys(keys)) == 2 * len(tp.buckets.ladder(1024))
    assert trc.capturable_keys(keys, one_device=False) == set()


def test_key_budget_states_the_graphs_it_could_capture():
    tp = _dense_pair()[1]
    (f,) = trc.check_key_budget(tp.buckets, 64, devices=1,
                                noise_enabled=True, budget=10)
    rungs = len(tp.buckets.ladder(64))
    assert f.code == "RC001" and f"could capture {2 * rungs} CUDA" \
        in f.message


def test_weak_cache_key_detected():
    def weak_key(kind, extent, *, noise, keyed, devices, bound,
                 reference, segmented, identity, point=""):
        return (kind, extent, noise, keyed, devices, bound, reference,
                identity, point)
    for mod in (trc, jrc):
        findings = mod.check_key_sensitivity(weak_key)
        assert [f.code for f in findings] == ["RC002"]
        assert "segmented" in findings[0].message


def test_real_executable_key_is_sensitive():
    assert trc.check_key_sensitivity() == []
    assert set(tprog.EXEC_KEY_FIELDS) <= set(trc._FIELD_PROBES)
    assert trc._FIELD_PROBES == jrc._FIELD_PROBES
    assert trc.DEFAULT_KEY_BUDGET == jrc.DEFAULT_KEY_BUDGET == 2048
    assert trc.DEFAULT_POINTS == jrc.DEFAULT_POINTS


def test_executable_key_shape():
    kw = dict(noise=False, keyed=False, devices=1, bound=True,
              reference=False, segmented=True, identity=False)
    k = tprog.executable_key("bucket", 8, **kw)
    assert len(k) == len(tprog.EXEC_KEY_FIELDS)
    assert k == jprog.executable_key("bucket", 8, **kw)
    assert tprog.EXEC_KEY_FIELDS == jprog.EXEC_KEY_FIELDS


# ---------------------------------------------------------------------------
# plan validator (contracts 16-18 and every PV code)
# ---------------------------------------------------------------------------

def test_plan_validator_clean_on_head():
    jplan, tplan = _plans()
    assert tpc.check_plan(tplan) == [] and jpc.check_plan(jplan) == []


def _lenet_plans(sharding=False):
    jconv = jmap.conv_layer_spec(2, 8, 8, 1, 8, padding=1)
    tconv = tmap.conv_layer_spec(2, 8, 8, 1, 8, padding=1)
    jcfg, tcfg = jrt.EngineConfig(), trt.EngineConfig()
    if sharding:
        jcfg = jrt.EngineConfig(sharding=jrt.ShardingConfig(devices=4))
        tcfg = trt.EngineConfig(sharding=trt.ShardingConfig(
            devices=4, fold_onto="cpu"))
    return (jrt.plan_network([jconv, jmap.LayerSpec(m=2, k=128, n=4)], jcfg,
                             ["relu", "none"], [2, 1]),
            trt.plan_network([tconv, tmap.LayerSpec(m=2, k=128, n=4)], tcfg,
                             ["relu", "none"], [2, 1]))


def _seeded_layer(kind, lp):
    """One seeded violation of the plan envelope, applied to either
    package's LayerPlan."""
    rep = dataclasses.replace
    if kind == "PV001":
        return rep(lp, spec=rep(lp.spec, r_in=11))
    if kind == "PV002":
        return rep(lp, spec=rep(lp.spec, r_w=3))
    if kind == "PV003":
        return rep(lp, k_slices=((0, 32), (40, 24)))
    if kind == "PV004":
        return rep(lp, spec=rep(lp.spec, k=2000), k_slices=((0, 2000),))
    if kind == "PV005":
        return rep(lp, n_slices=((0, 16), (16, 8)))
    if kind == "PV006":
        return rep(lp, spec=rep(lp.spec, m=lp.spec.m + 1))
    if kind == "PV007":
        return rep(lp, shard=rep(lp.shard, rows_per_device=1))
    raise ValueError(kind)


@pytest.mark.parametrize("code", ["PV001", "PV002", "PV003", "PV004",
                                  "PV005", "PV006", "PV007"])
def test_plan_validator_flags_each_seeded_code(code):
    """Every seeded violation gives exactly JAX's codes and messages."""
    sharded = code == "PV007"
    jplan, tplan = _lenet_plans(sharded) if code in ("PV006", "PV007") \
        else _plans()
    i = 0
    if code == "PV007":
        i = next(j for j, lp in enumerate(tplan.layers)
                 if lp.shard.kind == "rows")
        assert jplan.layers[i].shard.kind == "rows"
    got = tpc.check_layer(_seeded_layer(code, tplan.layers[i]),
                          tplan.cfg.macro, i)
    want = jpc.check_layer(_seeded_layer(code, jplan.layers[i]),
                           jplan.cfg.macro, i)
    assert code in [f.code for f in got]
    assert [(f.code, f.message) for f in got] == \
        [(f.code, f.message) for f in want]


def test_plan_validator_flags_a_broken_chain():
    """PV008: the layer chain's shapes do not compose."""
    jplan, tplan = _plans((dict(m=8, k=64, n=32, r_in=4, r_w=2),
                           dict(m=8, k=32, n=8, r_in=4, r_w=2)))
    tbad = dataclasses.replace(tplan, layers=tplan.layers[::-1])
    jbad = dataclasses.replace(jplan, layers=jplan.layers[::-1])
    got, want = tpc.check_plan(tbad), jpc.check_plan(jbad)
    assert [f.code for f in got] == ["PV008"]
    assert [(f.code, f.message) for f in got] == \
        [(f.code, f.message) for f in want]


# ---------------------------------------------------------------------------
# check_program / verify / suppressions / JSON (contracts 19-24)
# ---------------------------------------------------------------------------

def test_check_program_clean_on_head_dense():
    jp, tp = _dense_pair()
    rep = ta.check_program(tp)
    assert rep.findings == [] and rep.ok()
    assert ja.check_program(jp).findings == []


def test_check_program_clean_on_head_noise():
    jp, tp = _dense_pair(noise=True)
    assert ta.check_program(tp).findings == []
    assert ja.check_program(jp).findings == []


def test_compile_program_verify_strict():
    specs = [tmap.LayerSpec(m=8, k=32, n=16, r_in=2, r_w=1)]
    prog = tprog.compile_program(specs, trt.EngineConfig(), device="cpu",
                                 verify="strict")
    assert prog is not None
    with pytest.raises(ValueError, match="unknown cimcheck mode"):
        ta.Report().raise_if("bogus")
    with pytest.raises(ValueError, match="unknown cimcheck mode"):
        tprog.compile_program(specs, trt.EngineConfig(), device="cpu",
                              verify="bogus")


def test_verify_strict_raises_on_errors():
    jp, tp = _dense_pair()
    rep = ta.check_program(tp, key_budget=1)
    assert not rep.ok()
    assert rep.codes() == ja.check_program(jp, key_budget=1).codes()
    with pytest.raises(ta.CimcheckError) as ei:
        rep.raise_if("strict")
    assert "RC001" in str(ei.value)
    with pytest.raises(ta.CimcheckError):
        ta.verify_program(tp, "strict", key_budget=1)


def test_suppressions_waive_findings():
    jp, tp = _dense_pair()
    spec = ["recompile/RC001:known ladder size"]
    sups = ta.parse_suppressions(spec)
    rep = ta.check_program(tp, key_budget=1, suppressions=sups)
    assert rep.ok()
    assert [f.code for f in rep.suppressed] == ["RC001"]
    assert sups[0].reason == "known ladder size"
    assert ta.Suppression("recompile", "*").matches(rep.suppressed[0])
    jrep = ja.check_program(jp, key_budget=1,
                            suppressions=ja.parse_suppressions(spec))
    assert [f.code for f in jrep.suppressed] == ["RC001"]


def test_report_json_roundtrip():
    jp, tp = _dense_pair()
    rep = ta.check_program(tp)
    payload = json.loads(rep.to_json())
    assert payload == json.loads(ja.check_program(jp).to_json())
    assert payload["ok"] is True and payload["findings"] == []
    seeded = ta.check_program(tp, key_budget=1)
    back = ta.Report.from_json(seeded.to_json())
    assert back.findings == seeded.findings and not back.ok()


def test_verify_leaves_no_trace_in_the_caches():
    """A check binds nothing in the bound-program cache, plans nothing,
    captures nothing and moves no dispatch or launch counter."""
    conv = tmap.conv_layer_spec(2, 8, 8, 1, 4, padding=1)
    prog = tprog.compile_program(
        [conv, tmap.LayerSpec(m=2, k=64, n=10)],
        trt.EngineConfig(noise=tnm.NoiseConfig(enabled=True)),
        activations=["relu", "none"], pools=[2, 1], device="cpu")
    before = (tprog.bound_cache_stats(), dict(trt.PLAN_COUNT),
              dict(trt.CAPTURE_COUNT), prog.stats(),
              kmod.launch_counts(), tprog.program_cache_stats())
    assert ta.check_program(prog).findings == []
    ta.verify_program(prog, "strict", graphs="serving")
    after = (tprog.bound_cache_stats(), dict(trt.PLAN_COUNT),
             dict(trt.CAPTURE_COUNT), prog.stats(),
             kmod.launch_counts(), tprog.program_cache_stats())
    assert after == before


def test_check_all_cached_programs_sweeps_the_plan_table():
    tp = _dense_pair()[1]
    rep = ta.check_all_cached_programs("strict", lint_graphs=False)
    assert rep.ok()
    assert tp in tprog._PLAN_PROGRAMS.values()


# ---------------------------------------------------------------------------
# the zoo sweep and its CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r_in,r_w", [(4, 2), (1, 4)])
def test_zoo_head_is_clean(r_in, r_w):
    """LeNet, OLMo-1B's and phi3.5-moe's projections (smoke widths), and
    the noisy, folded sharded and mixed-ladder points give no ERROR, as
    JAX's head."""
    progs = tcli.programs_for("lenet", r_in, r_w, "cpu") \
        + tcli.programs_for("olmo-1b", r_in, r_w, "cpu") \
        + tcli.programs_for("phi3.5-moe-42b-a6.6b", r_in, r_w, "cpu")
    for label, prog in progs:
        assert ta.check_program(prog).findings == [], label
    jlabels = [lab for lab, _ in ja_programs(r_in, r_w)]
    assert [lab for lab, _ in progs] == jlabels


def ja_programs(r_in, r_w):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" \
        / "cimcheck.py"
    spec = importlib.util.spec_from_file_location("_jax_cimcheck", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._programs_for("lenet", r_in, r_w) \
        + mod._programs_for("olmo-1b", r_in, r_w) \
        + mod._programs_for("phi3.5-moe-42b-a6.6b", r_in, r_w)


def test_extra_points_are_clean():
    labels = []
    for label, prog, pts in tcli.extra_points("cpu"):
        labels.append(label)
        rep = ta.check_program(prog, points=pts)
        assert rep.findings == [], label
    assert labels == ["lenet+noise", f"lenet+shard{tcli.SHARD_DEVICES}",
                      "mixed-ladder"]
    assert tcli.LADDER_POINTS == ("", "quality", "balanced", "throughput")


def test_cli_writes_a_report_it_reads_back(tmp_path, capsys):
    out = tmp_path / "findings.json"
    rc = tcli.main(["--device", "cpu", "--strict", "--json", str(out),
                    "--r-in", "2", "--r-w", "2", "--no-extra"])
    text = capsys.readouterr().out
    assert rc == 0
    assert "not registered" not in text
    assert "SASS pass skipped" in text
    payload = json.loads(out.read_text())
    assert payload["ok"] is True and payload["sass"] is None
    assert [c["config"] for c in payload["configs"]] == [
        "lenet", "olmo-1b/qkv", "olmo-1b/o", "olmo-1b/gate_up",
        "olmo-1b/down"] + [f"phi3.5-moe-42b-a6.6b/{n}"
                           for n in ("qkv", "o", "gate_up", "down")]
    back = ta.Report.from_json(out.read_text())
    assert back.ok() and back.findings == []
    # a waived error keeps --strict at 0; the report carries it
    rc = tcli.main(["--device", "cpu", "--strict", "--json", str(out),
                    "--arch", "lenet", "--r-in", "2", "--r-w", "2",
                    "--no-extra", "--max-m", "1", "--suppress",
                    "plan/PV00*"])
    assert rc == 0


def test_cli_strict_fails_on_an_error(monkeypatch, capsys):
    """A surviving ERROR makes --strict exit 1."""
    monkeypatch.setattr(trc, "DEFAULT_KEY_BUDGET", 1)
    real = ta.check_program

    def tight(prog, **kw):
        return real(prog, **dict(kw, key_budget=1))
    monkeypatch.setattr(tcli, "check_program", tight)
    assert tcli.main(["--device", "cpu", "--strict", "--arch", "lenet",
                      "--r-in", "4", "--r-w", "2", "--no-extra"]) == 1
    assert "RC001" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the legacy entry points against JAX's
# ---------------------------------------------------------------------------

def _seeded(dims, seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, k ** -0.5, size=(k, n)).astype(np.float32),
             "abn_log_gamma": rng.uniform(-1, 5, size=n).astype(np.float32),
             "abn_beta": rng.uniform(-4, 4, size=n).astype(np.float32)}
            for k, n in dims]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype \
        and np.array_equal(a.view(np.int32), b.view(np.int32))


def test_legacy_dense_entries_match_jax():
    """run_network, run_network_reference and CIMInferenceEngine's call
    and reference on one dense layer: bit for bit with JAX's."""
    spec = dict(m=8, k=72, n=16, r_in=4, r_w=2)
    jeng = jrt.CIMInferenceEngine([jmap.LayerSpec(**spec)])
    teng = trt.CIMInferenceEngine([tmap.LayerSpec(**spec)], device="cpu")
    p = _seeded([(72, 16)], 3)
    x = np.random.default_rng(4).normal(size=(8, 72)).astype(np.float32)
    tx, tp = torch.from_numpy(x), params_from_numpy(p)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = np.asarray(jeng(p, jnp.asarray(x)))
        assert _same(want, teng(tp, tx))
        assert _same(want, trt.run_network(teng.plan, tp, tx, device="cpu"))
        assert _same(np.asarray(jrt.run_network(jeng.plan, p,
                                                jnp.asarray(x))), want)
    assert _same(want, teng.reference(tp, tx))
    assert _same(want, trt.run_network_reference(teng.plan, tp, tx,
                                                 device="cpu"))
    assert _same(np.asarray(jrt.run_network_reference(
        jeng.plan, p, jnp.asarray(x))), want)
    assert teng.compile() is teng.program
    assert teng.program.device.type == "cpu"
    assert teng.perf_report()["program"] is not None
    # JAX's init_params(key) drawn bit for bit from the port's key
    jinit = jeng.init_params(jax.random.PRNGKey(5))
    tinit = teng.init_params(prng.key(5))
    assert all(_same(np.asarray(j[f]), t[f].numpy())
               for j, t in zip(jinit, tinit) for f in j)


def test_legacy_lenet_entries_match_jax():
    """A small LeNet (batch 2) through the legacy entries: the port's call
    == its reference == JAX's reference, and run_network == the call."""
    jconv = [jmap.conv_layer_spec(2, 8, 8, 1, 4, padding=1),
             jmap.conv_layer_spec(2, 4, 4, 4, 8, padding=1)]
    tconv = [tmap.conv_layer_spec(2, 8, 8, 1, 4, padding=1),
             tmap.conv_layer_spec(2, 4, 4, 4, 8, padding=1)]
    acts, pools = ["relu", "relu", "none"], [2, 2, 1]
    jeng = jrt.CIMInferenceEngine(
        jconv + [jmap.LayerSpec(m=2, k=32, n=10)], activations=acts,
        pools=pools)
    teng = trt.CIMInferenceEngine(
        tconv + [tmap.LayerSpec(m=2, k=32, n=10)], activations=acts,
        pools=pools, device="cpu")
    p = _seeded([(9, 4), (36, 8), (32, 10)], 6)
    x = np.clip(np.random.default_rng(7).normal(0.3, 0.4, (2, 8, 8, 1)),
                0, 1).astype(np.float32)
    want = np.asarray(jeng.reference(p, jnp.asarray(x)))
    tx, tp = torch.from_numpy(x), params_from_numpy(p)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = teng(tp, tx)
        assert _same(want, got)
        assert torch.equal(trt.run_network(teng.plan, tp, tx, device="cpu"),
                           got)
    assert _same(want, teng.reference(tp, tx))
    assert _same(want, trt.run_network_reference(teng.plan, tp, tx,
                                                 device="cpu"))


def test_legacy_monte_carlo_matches_jax():
    """Four seeded trials under NoiseConfig: trial t is JAX's monte_carlo
    trial t and the port's run under split key t, bit for bit."""
    spec = dict(m=8, k=72, n=16, r_in=4, r_w=2)
    jeng = jrt.CIMInferenceEngine(
        [jmap.LayerSpec(**spec)],
        jrt.EngineConfig(noise=jnm.NoiseConfig(enabled=True)))
    teng = trt.CIMInferenceEngine(
        [tmap.LayerSpec(**spec)],
        trt.EngineConfig(noise=tnm.NoiseConfig(enabled=True)), device="cpu")
    p = _seeded([(72, 16)], 8)
    x = np.maximum(np.random.default_rng(9).normal(size=(8, 72)),
                   0).astype(np.float32)
    tx, tp = torch.from_numpy(x), params_from_numpy(p)
    got = teng.monte_carlo(tp, tx, prng.key(11), 4)
    assert tuple(got.shape) == (4, 8, 16)
    keys = prng.split(prng.key(11), 4)
    assert np.array_equal(
        np.asarray(jax.random.split(jax.random.PRNGKey(11), 4)),
        keys.numpy())
    for t in range(4):
        assert torch.equal(got[t], teng.program.run(tp, tx, keys[t]))
    want = np.asarray(jeng.monte_carlo(p, jnp.asarray(x),
                                       jax.random.PRNGKey(11), 4))
    assert _same(want, got.numpy())
    assert not torch.equal(got[0], got[1])


def test_legacy_monte_carlo_raises_as_jax():
    clean = trt.CIMInferenceEngine([tmap.LayerSpec(m=2, k=8, n=4)],
                                   device="cpu")
    jclean = jrt.CIMInferenceEngine([jmap.LayerSpec(m=2, k=8, n=4)])
    p = _seeded([(8, 4)], 1)
    for eng, params, x, key in (
            (clean, params_from_numpy(p), torch.ones(2, 8), prng.key(0)),
            (jclean, p, jnp.ones((2, 8)), jax.random.PRNGKey(0))):
        with pytest.raises(ValueError, match="requires EngineConfig"):
            eng.monte_carlo(params, x, key, 2)
    noisy = trt.CIMInferenceEngine(
        [tmap.LayerSpec(m=2, k=8, n=4)],
        trt.EngineConfig(noise=tnm.NoiseConfig(enabled=True)), device="cpu")
    with pytest.raises(ValueError, match="n_trials must be >= 1"):
        noisy.monte_carlo(params_from_numpy(p), torch.ones(2, 8),
                          prng.key(0), 0)


def test_legacy_entries_warn_once_a_process(monkeypatch):
    monkeypatch.setitem(trt._DEPRECATION, "warned", False)
    eng = trt.CIMInferenceEngine([tmap.LayerSpec(m=2, k=8, n=4)],
                                 device="cpu")
    p, x = params_from_numpy(_seeded([(8, 4)], 2)), torch.ones(2, 8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng(p, x)
        trt.run_network(eng.plan, p, x, device="cpu")
        eng(p, x)
    msgs = [str(w.message) for w in caught
            if w.category is DeprecationWarning]
    assert len(msgs) == 1
    assert msgs[0].startswith("CIMInferenceEngine.__call__ re-enters the "
                              "engine per call")
    assert "repro_torch.runtime.program.compile_program" in msgs[0]


def test_legacy_entries_run_on_the_card_by_default():
    """No device means CUDA: on a host without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.CIMInferenceEngine([tmap.LayerSpec(m=2, k=8, n=4)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--arch", "lenet", "--r-in", "4", "--r-w", "2"])
