"""Noise-key injectivity pass (pass id ``noise``).

Counterpart of `repro/analysis/noise_keys.py` over the chains the port
folds.  Every draw of a noisy run is the threefry stream of a key folded
from the run's key (`core/prng.fold_in`, JAX's `fold_in` bit for bit), and
its determinism and isolation contracts rest on no two draws sharing a
complete fold chain.  Layer i draws under fold_in(key, i)
(`engine._forward`); `engine._stream_keys` then folds, per layer:

  * the SA-residue stream:  (i, 0)
  * positional thermal:     (i, 1, row_tile, col_tile, row_block), one
    stream per `engine.NOISE_ROW_BLOCK` GEMM rows
  * identity-keyed thermal: (i, 1, row_tile, col_tile, noise_id, sub),
    one stream per GEMM row

Two draws collide exactly when their chains are equal (threefry is a
bijection of the counter under a key, so distinct chains of one length
give distinct keys but for a negligible chance).  The pass enumerates
every chain a plan emits for a row extent, in `_stream_keys`' order,
proves the set collision-free, and audits `program.NOISE_ID_STRIDE`'s
request ranges and the scheduler's ids (`CIMDecodeLM.noise_id`).

Finding codes (the JAX package's):

  * **NK001** - two enumerated chains collide (a structural engine bug);
  * **NK002** - a duplicate noise id within one fused batch;
  * **NK003** - two requests' `NOISE_ID_STRIDE` id ranges overlap;
  * **NK004** - a request's id range leaves int32 (`request_index >=
    2048` wraps ``request_index * NOISE_ID_STRIDE``);
  * **NK005** - (WARNING) the scheduler's uid/call arithmetic wraps its
    2**31 modulus, reusing another request's id range.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, Report, Severity

PASS_ID = "noise"

INT32_MAX = 0x7FFFFFFF


def _stride() -> int:
    from repro_torch.runtime.program import NOISE_ID_STRIDE
    return NOISE_ID_STRIDE


def stream_chains(lp, m: int, *, noise_ids: Optional[Sequence[int]] = None,
                  row_sub: Optional[Sequence[int]] = None
                  ) -> List[Tuple[int, ...]]:
    """The chains `engine._stream_keys` folds onto one layer's key, in its
    order: the residue stream (0,), then per (row tile ki, col tile ni),
    ki outer, the positional blocks (1, ki, ni, b) or, with noise ids,
    the rows (1, ki, ni, id, sub)."""
    from repro_torch.runtime.engine import NOISE_ROW_BLOCK
    chains: List[Tuple[int, ...]] = [(0,)]
    n_blocks = -(-max(m, 1) // NOISE_ROW_BLOCK)
    subs = (list(row_sub) if row_sub is not None
            else [0] * (0 if noise_ids is None else len(noise_ids)))
    for ki in range(len(lp.k_slices)):
        for ni in range(len(lp.n_slices)):
            if noise_ids is None:
                chains += [(1, ki, ni, b) for b in range(n_blocks)]
            else:
                chains += [(1, ki, ni, int(rid), int(sub))
                           for rid, sub in zip(noise_ids, subs)]
    return chains


def enumerate_fold_tuples(plan, m: int, *,
                          noise_ids: Optional[Sequence[int]] = None,
                          row_sub: Optional[Sequence[int]] = None
                          ) -> List[Tuple[int, ...]]:
    """Every complete fold chain the plan emits for row extent ``m``: the
    layer index, then `stream_chains` of the layer."""
    return [(i,) + c for i, lp in enumerate(plan.layers)
            for c in stream_chains(lp, m, noise_ids=noise_ids,
                                   row_sub=row_sub)]


def check_injectivity(plan, m: int, *,
                      noise_ids: Optional[Sequence[int]] = None,
                      row_sub: Optional[Sequence[int]] = None
                      ) -> List[Finding]:
    """NK001/NK002: prove the plan's fold-chain set is collision-free."""
    findings: List[Finding] = []
    if noise_ids is not None:
        findings.extend(check_noise_ids(noise_ids, row_sub=row_sub))
    seen: Dict[Tuple[int, ...], int] = {}
    for chain in enumerate_fold_tuples(plan, m, noise_ids=noise_ids,
                                       row_sub=row_sub):
        n = seen.get(chain, 0) + 1
        seen[chain] = n
        if n == 2:             # report each colliding chain once
            findings.append(Finding(
                pass_id=PASS_ID, code="NK001", severity=Severity.ERROR,
                message=f"fold_in chain {chain} emitted more than once; "
                        "independent noise draws would be identical",
                layer=chain[0]))
    return findings


def check_noise_ids(noise_ids: Sequence[int], *,
                    row_sub: Optional[Sequence[int]] = None
                    ) -> List[Finding]:
    """NK002: duplicate (noise_id, sub) pairs within one fused batch."""
    findings: List[Finding] = []
    subs = (list(row_sub) if row_sub is not None else [0] * len(noise_ids))
    seen: Dict[Tuple[int, int], int] = {}
    for rid, sub in zip((int(r) for r in noise_ids), subs):
        pair = (rid, int(sub))
        n = seen.get(pair, 0) + 1
        seen[pair] = n
        if n == 2:
            findings.append(Finding(
                pass_id=PASS_ID, code="NK002", severity=Severity.ERROR,
                message=f"noise id {pair[0]} (sub {pair[1]}) appears more "
                        "than once in a fused batch; the duplicated rows "
                        "would share identity-keyed thermal draws"))
    return findings


def check_request_ranges(requests: Iterable[Tuple[int, int]]
                         ) -> List[Finding]:
    """NK003/NK004: audit `request_noise_ids`-style (index, rows) ranges.

    Request ``(request_index, rows)`` claims ids ``[request_index *
    NOISE_ID_STRIDE, request_index * NOISE_ID_STRIDE + rows)``; the ranges
    must stay disjoint and inside int32."""
    stride = _stride()
    findings: List[Finding] = []
    spans: List[Tuple[int, int, int]] = []
    for idx, rows in requests:
        lo = idx * stride
        hi = lo + rows          # exclusive
        if rows > stride:
            findings.append(Finding(
                pass_id=PASS_ID, code="NK003", severity=Severity.ERROR,
                message=f"request {idx} needs {rows} ids but "
                        f"NOISE_ID_STRIDE is {stride}; its range bleeds "
                        "into the next request's"))
        if idx < 0 or hi - 1 > INT32_MAX:
            findings.append(Finding(
                pass_id=PASS_ID, code="NK004", severity=Severity.ERROR,
                message=f"request {idx} id range [{lo}, {hi}) leaves int32 "
                        f"(max {INT32_MAX}); request_noise_ids would wrap "
                        "into another request's range "
                        "(request_index >= 2048 overflows)"))
            continue
        spans.append((lo, hi, idx))
    spans.sort()
    for (lo_a, hi_a, idx_a), (lo_b, hi_b, idx_b) in zip(spans, spans[1:]):
        if lo_b < hi_a:
            findings.append(Finding(
                pass_id=PASS_ID, code="NK003", severity=Severity.ERROR,
                message=f"requests {idx_a} and {idx_b} claim overlapping "
                        f"noise-id ranges [{lo_a},{hi_a}) and "
                        f"[{lo_b},{hi_b})"))
    return findings


def check_scheduler_limits(*, max_requests: int,
                           max_calls_per_request: int) -> List[Finding]:
    """NK005: can `CIMDecodeLM.noise_id(uid, call)` wrap its modulus?

    Asked of the scheduler's own function: the last uid's range must
    start where the stride puts it (``noise_id`` reduces modulo 2**31,
    which aliases uid 2048 onto uid 0), and a request's last call must
    stay below the next uid's first id."""
    from repro_torch.runtime.scheduler import CIMDecodeLM
    stride = _stride()
    nid = CIMDecodeLM.noise_id
    findings: List[Finding] = []
    if max_requests > 0 and nid(max_requests - 1, 0) \
            != (max_requests - 1) * stride:
        findings.append(Finding(
            pass_id=PASS_ID, code="NK005", severity=Severity.WARNING,
            message=f"serving {max_requests} requests exceeds the "
                    f"{(INT32_MAX + 1) // stride} distinct uid ranges the "
                    "2**31 noise-id modulus provides; ranges recycle"))
    if max_calls_per_request > 0 \
            and nid(0, max_calls_per_request - 1) >= nid(1, 0):
        findings.append(Finding(
            pass_id=PASS_ID, code="NK005", severity=Severity.WARNING,
            message=f"a request may issue {max_calls_per_request} decode "
                    f"calls but NOISE_ID_STRIDE is {stride}; its call "
                    "counter bleeds into the next uid's id range"))
    return findings


def run(plan, m: int, *, noise_ids: Optional[Sequence[int]] = None,
        row_sub: Optional[Sequence[int]] = None,
        requests: Optional[Iterable[Tuple[int, int]]] = None,
        max_requests: int = 0, max_calls_per_request: int = 0) -> Report:
    """Run the full noise-key pass over one plan; returns a Report."""
    report = Report()
    report.extend(check_injectivity(plan, m, noise_ids=noise_ids,
                                    row_sub=row_sub))
    if requests is not None:
        report.extend(check_request_ranges(requests))
    if max_requests or max_calls_per_request:
        report.extend(check_scheduler_limits(
            max_requests=max_requests,
            max_calls_per_request=max_calls_per_request))
    return report
