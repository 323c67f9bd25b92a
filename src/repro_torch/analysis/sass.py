"""SASS check of the ADC floor (pass id ``sass``): what the card runs.

The port's counterpart of `lint_hlo_text` (NB101), moved from the
compiler's input to its output.  The integer contract of the `cim_mbiw`
epilogue (`kernels/cim_mbiw/csrc/cim_epilogue.cuh` `adc_code`) is
``floor((mid + f32(f32(gamma*g0) * f32(dp))) + beta)``, every step
rounded on its own.  ``nvcc`` contracts ``mid + gain*dp`` into one fused
multiply-add wherever the source lets it (plain ``*`` and ``+`` without
``__fmul_rn`` / ``__fadd_rn``), and the fused sum rounds once: a code at a
floor boundary then moves by one.  The host graph's barrier lint cannot
see into a kernel, and a dynamic canary (`kernels/cim_mbiw/ref.py
fma_canary`) only sees the branches its inputs reach.  This pass reads
the machine code itself:

  * `cuobjdump -sass` (next to `nvcc`, found as `kernels/build.py`
    finds it) disassembles a built kernel library;
  * the listing splits per function, and each function into
    instructions (address, guard predicate, opcode, operands);
  * from every rounding sink - ``FRND`` (floor, ceil, nearest; not
    ``.TRUNC``) and ``F2I`` with ``FLOOR`` or ``CEIL`` - the walk goes
    backwards through register definitions in straight-line code: a
    branch target, a reconvergence point (``BSSY``'s address) or the
    instruction after an unconditional branch or ``EXIT`` ends it.  A
    predicated definition (``@P0 ...``) may not have run, so the walk
    follows it and also the definition before it;
  * it passes through the data moves and rounded float ops (``FADD``,
    ``FMUL``, ``FMNMX``, ``FSEL``, ``SEL``, ``MOV``, ``IMAD.MOV``) and
    stops at anything else (loads, conversions, integer arithmetic);
  * **NB102** (ERROR): an ``FFMA`` / ``FFMA2`` / ``FFMA32I`` on a sink's
    slice.

`lint_library(name)` runs it on a library `kernels/build.py` built,
`lint_sass(text)` on a listing; both return a `SassReport` with each
function's sinks and the fused multiply-adds on their slices.  Without
`cuobjdump` or the built library the pass raises with the reason; it
never returns a clean report it did not check.  The parser and the walk
are plain Python over text, so the CPU tests hold them to listings
captured on an H100.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.findings import Finding, Severity

PASS_ID = "sass"

# one instruction of a cuobjdump listing: /*addr*/ [@guard] OPCODE ops ;
_INSN_RE = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:(@!?U?P[T0-9]+)\s+)?([A-Z][A-Z0-9_.]*)"
    r"\s*([^;]*);")
_FUNC_RE = re.compile(r"^\s*Function\s*:\s*(\S+)")
_REG_RE = re.compile(r"^[-!|~]*(U?R(?:\d+|Z))")
_HEX_RE = re.compile(r"\b0x([0-9a-f]+)\b")

# control flow whose hex operand is a join point
_TARGET_OPS = ("BRA", "BRX", "JMP", "JMX", "BSSY", "SSY", "PBK", "PCNT",
               "CALL", "CAL", "BREAK")
_END_OPS = ("BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "KILL")
# opcodes whose leading predicate operand precedes the register result
_PRED_FIRST = ("SHFL", "ATOMG", "ATOM", "ATOMS", "ELECT")
# opcodes that write only predicates
_PRED_ONLY = ("ISETP", "FSETP", "DSETP", "HSETP2", "PSETP", "PLOP3",
              "UISETP", "UPLOP3", "R2P", "FCHK")
# moves and rounded float ops the walk passes through
_TRANSPARENT = ("FADD", "FMUL", "FMNMX", "FSEL", "SEL", "MOV", "UMOV",
                "IMAD.MOV", "FADD32I", "FMUL32I", "USEL")
_FMA = ("FFMA", "FFMA2", "FFMA32I")

# a contractible ADC epilogue: the contract's expression with plain
# operators, which nvcc fuses into fma(gain, dp, mid).  chip_smoke and
# the card tests compile it with kernels/build.py's flags and hold the
# pass to reporting it.
SEEDED_EPILOGUE = r"""
extern "C" __global__ void seeded_adc(const float* gamma, const int* dp,
                                      const float* beta, float g0,
                                      float mid, int* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float gain = gamma[i] * g0;
    out[i] = (int)floorf(mid + gain * (float)dp[i] + beta[i]);
  }
}
"""


@dataclasses.dataclass(frozen=True)
class Insn:
    """One SASS instruction."""
    addr: int
    guard: str            # "" or "@P0", "@!P1", ...
    opcode: str           # "FFMA", "FRND.FLOOR", ...
    operands: Tuple[str, ...]

    @property
    def base(self) -> str:
        return self.opcode.split(".")[0]

    def text(self) -> str:
        g = f"{self.guard} " if self.guard else ""
        ops = ", ".join(self.operands)
        return f"/*{self.addr:04x}*/ {g}{self.opcode} {ops}"


@dataclasses.dataclass
class FunctionReport:
    """One function's result: rounding sinks found, fused multiply-adds
    on their slices (0 is the contract) and in the whole function."""
    library: str
    function: str
    sinks: int
    ffma_on_slice: int
    ffma_total: int


@dataclasses.dataclass
class SassReport:
    """Per-function results and the NB102 findings of one or more
    listings."""
    functions: List[FunctionReport] = dataclasses.field(default_factory=list)
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def merge(self, other: "SassReport") -> None:
        self.functions += other.functions
        self.findings += other.findings

    def totals(self) -> Dict[str, int]:
        """Functions, sinks and FFMAs on the sinks' slices, summed."""
        return {"functions": len(self.functions),
                "sinks": sum(f.sinks for f in self.functions),
                "ffma_on_slice": sum(f.ffma_on_slice
                                     for f in self.functions)}


def _split_operands(text: str) -> Tuple[str, ...]:
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return tuple(out)


def parse_functions(text: str) -> Dict[str, List[Insn]]:
    """Split a `cuobjdump -sass` listing into {function: instructions}.
    Encoding comments and header lines are skipped."""
    funcs: Dict[str, List[Insn]] = {}
    cur: Optional[List[Insn]] = None
    for line in text.splitlines():
        m = _FUNC_RE.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN_RE.match(line)
        if m and cur is not None:
            cur.append(Insn(int(m.group(1), 16), m.group(2) or "",
                            m.group(3), _split_operands(m.group(4))))
    return funcs


def _reg(tok: str) -> Optional[str]:
    m = _REG_RE.match(tok)
    if m is None or m.group(1) in ("RZ", "URZ"):
        return None
    return m.group(1)


def _width(insn: Insn) -> int:
    """Registers the destination spans."""
    op = insn.opcode
    if "GMMA" in op:
        m = re.search(r"\.(\d+)x(\d+)x\d+", op)
        return max(int(m.group(2)) // 2, 1) if m else 1
    if ".128" in op:
        return 4
    if ".64" in op or "WIDE" in op:
        return 2
    return 1


def _dest(insn: Insn) -> Tuple[str, ...]:
    """The registers an instruction writes (empty for stores, branches,
    predicate-only ops)."""
    if insn.base in _PRED_ONLY or not insn.operands:
        return ()
    ops = list(insn.operands)
    if insn.base in _PRED_FIRST and ops and not _reg(ops[0]):
        ops = ops[1:]
    first = ops[0] if ops else ""
    r = _reg(first)
    if r is None or first.startswith(("[", "desc[", "c[", "gdesc[")):
        return ()
    m = re.match(r"(U?R)(\d+)", r)
    return tuple(f"{m.group(1)}{int(m.group(2)) + i}"
                 for i in range(_width(insn)))


def _sources(insn: Insn) -> List[str]:
    dst = _dest(insn)
    regs = []
    for i, tok in enumerate(insn.operands):
        if i == 0 and dst:
            continue
        r = _reg(tok)
        if r is not None:
            regs.append(r)
    return regs


def _is_sink(insn: Insn) -> bool:
    if insn.base == "FRND":
        return ".TRUNC" not in insn.opcode
    return insn.base == "F2I" and ("FLOOR" in insn.opcode
                                   or "CEIL" in insn.opcode)


def _block_starts(insns: List[Insn]) -> set:
    """Indices at which straight-line code starts: join points and the
    instructions after an unconditional branch or exit."""
    index = {ins.addr: i for i, ins in enumerate(insns)}
    starts = {0}
    for i, ins in enumerate(insns):
        if ins.base in _TARGET_OPS:
            for h in _HEX_RE.findall(" ".join(ins.operands)):
                j = index.get(int(h, 16))
                if j is not None:
                    starts.add(j)
        if ins.base in _END_OPS and not ins.guard:
            starts.add(i + 1)
    return starts


def _on_slice(insns: List[Insn], starts: set, sink: int) -> List[int]:
    """Indices of the fused multiply-adds on the backward slice of the
    sink at `sink` (straight-line code only)."""
    hits: List[int] = []
    seen = set()
    work = [(sink, r) for r in _sources(insns[sink])]
    while work:
        at, reg = work.pop()
        if (at, reg) in seen:
            continue
        seen.add((at, reg))
        i = at
        while i not in starts:
            i -= 1
            ins = insns[i]
            if reg not in _dest(ins):
                continue
            if ins.base in _FMA:
                hits.append(i)
            elif ins.opcode.startswith(_TRANSPARENT):
                work.extend((i, r) for r in _sources(ins))
            if not ins.guard:
                break          # an unpredicated definition kills the walk
    return hits


def lint_function(name: str, insns: List[Insn], *,
                  library: str = "") -> Tuple[FunctionReport,
                                              List[Finding]]:
    """NB102 over one function's instructions."""
    starts = _block_starts(insns)
    sinks = [i for i, ins in enumerate(insns) if _is_sink(ins)]
    findings, on_slice = [], set()
    for s in sinks:
        for i in _on_slice(insns, starts, s):
            if i in on_slice:
                continue
            on_slice.add(i)
            where = f"{library}:{name}" if library else name
            findings.append(Finding(
                pass_id=PASS_ID, code="NB102", severity=Severity.ERROR,
                message=f"{insns[i].text()} feeds {insns[s].text()}: a "
                        "fused multiply-add on the floor's argument rounds "
                        "once where the contract rounds twice; use "
                        "__fmul_rn / __fadd_rn", where=where))
    fr = FunctionReport(library, name, len(sinks), len(on_slice),
                        sum(ins.base in _FMA for ins in insns))
    return fr, findings


def lint_sass(text: str, *, library: str = "") -> SassReport:
    """Run the pass over a `cuobjdump -sass` listing."""
    out = SassReport()
    funcs = parse_functions(text)
    if not funcs:
        raise ValueError(f"no SASS function in the listing of "
                         f"{library or 'the given text'}")
    for name, insns in funcs.items():
        fr, f = lint_function(name, insns, library=library)
        out.functions.append(fr)
        out.findings += f
    return out


def cuobjdump_path() -> str:
    """`cuobjdump` of the toolkit whose nvcc builds the kernels."""
    from repro_torch.kernels.build import nvcc_path
    cand = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if os.path.exists(cand):
        return cand
    found = shutil.which("cuobjdump")
    if found:
        return found
    raise RuntimeError(f"cuobjdump not found next to {nvcc_path()} or on "
                       "PATH: the SASS pass needs the CUDA toolkit")


def disassemble(path) -> str:
    """`cuobjdump -sass` of a built library or object; raises with
    cuobjdump's message when it fails."""
    path = Path(path)
    if not path.exists():
        raise RuntimeError(f"no built library at {path}")
    proc = subprocess.run([cuobjdump_path(), "-sass", str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {path} exited "
                           f"{proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout


def lint_path(path, library: str = "") -> SassReport:
    """The pass over the library or object at `path`."""
    return lint_sass(disassemble(path), library=library or Path(path).name)


def lint_library(name: str) -> SassReport:
    """The pass over the kernel library `name` of `kernels/build.py`, as
    this process built it (`build.build_all` / `build.load`).  Raises
    when it was not built: the pass checks nothing it cannot read."""
    from repro_torch.kernels import build
    info = build._BUILT.get(name)
    if info is None:
        raise RuntimeError(f"kernel library {name!r} was not built in this "
                           "process; run kernels.build.build_all() first")
    return lint_path(info.path, library=name)


def lint_built(names: Optional[Iterable[str]] = None) -> SassReport:
    """The pass over the named libraries (every source of
    `kernels/build.py` by default), building any that is missing (which
    needs nvcc, hence the card's toolkit)."""
    from repro_torch.kernels import build
    names = list(build.SOURCES if names is None else names)
    build.build_all(names)
    out = SassReport()
    for n in names:
        out.merge(lint_library(n))
    return out


def compile_source(source: str, name: str) -> Path:
    """Compile a CUDA source with `kernels/build.py`'s flags into its
    build directory (which `.gitignore` lists) and return the library's
    path; raises with nvcc's output on failure."""
    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"{name}.cu"
    out = build.BUILD_DIR / f"{name}.so"
    src.write_text(source)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return out
