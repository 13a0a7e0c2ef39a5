"""Instruction mix of the cluster kernels' inner loops, read from the
SASS that `cuobjdump -sass` prints for a built kernel library.

    python -m fovtrace_torch.scripts.sass_mix [LIB.so ...]

With no library it builds (or reuses) the port's cluster library. For
each kernel it finds the innermost loops that hold at least one pair's
40 FFMAs: a backward branch and the instructions from its target up to
it. Per loop it counts FFMA, shared-memory loads (LDS of any width), the
rest, and MUFU.RCP: each (ray, triangle) pair takes exactly one
reciprocal (1 / det), so the loop's MUFU.RCP count is its pairs per
iteration. The counts are static: an instruction in a branch inside the
loop counts once, however rarely it runs (the division and the best-hit
update run only for a pair that passes the edge tests). The IEEE
division adds a few FFMAs per pair to the dot products' 40. The loop's
head, from its first instruction to its first branch, is counted apart:
where that branch skips what few pairs need, the head is the path most
iterations take.

It needs `cuobjdump` (the CUDA toolkit's, or the one Triton ships).
"""

from __future__ import annotations

import argparse
import importlib.util
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, List

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = [Path("/usr/local/cuda/bin/cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cands.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin"
                     / "cuobjdump")
    for cand in cands:
        if cand.exists():
            return str(cand)
    raise RuntimeError("cuobjdump not found")


def functions(lib: str) -> Dict[str, List[tuple]]:
    """{mangled kernel name: [(address, opcode, operands), ...]} of a
    built library."""
    return parse(subprocess.run([cuobjdump(), "-sass", lib], check=True,
                                capture_output=True, text=True).stdout)


def parse(text: str) -> Dict[str, List[tuple]]:
    """`functions` of a `cuobjdump -sass` listing."""
    out: Dict[str, List[tuple]] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return out


def short_name(mangled: str) -> str:
    """closest_stream_kernel<4> from its mangled name."""
    m = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d+)EE)?", mangled)
    if not m:
        return mangled
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def _category(op: str) -> str:
    base = op.split(".")[0]
    if base == "FFMA":
        return "FFMA"
    if base == "LDS":
        return "LDS"
    if op.startswith("MUFU.RCP"):
        return "MUFU.RCP"
    return "other"


def inner_loops(insns: List[tuple]) -> List[dict]:
    """The innermost loops that hold at least one pair's dot products
    (40 FFMAs), each with its counts."""
    addr = [a for a, _, _ in insns]
    loops = []
    for a, op, rest in insns:
        if op.split(".")[0] != "BRA":
            continue
        t = re.search(r"0x([0-9a-f]+)", rest)
        if not t or int(t.group(1), 16) > a:
            continue
        lo = int(t.group(1), 16)
        body = [i for i, x in enumerate(addr) if lo <= x <= a]
        cnt = Counter(_category(insns[i][1]) for i in body)
        if cnt["FFMA"] >= 40:
            first = next(i for i in body
                         if insns[i][1].split(".")[0] == "BRA")
            head = Counter(_category(insns[i][1])
                           for i in body if i <= first)
            loops.append(dict(lo=lo, hi=a, n=len(body), counts=cnt,
                              head=head, head_n=first - body[0] + 1))
    inside = lambda o, lp: lp["lo"] <= o["lo"] and o["hi"] <= lp["hi"]
    return [lp for lp in loops
            if not any(o is not lp and inside(o, lp) for o in loops)]


def report(lib: str, tag: str = "[sass]") -> dict:
    """Print each kernel's inner-loop mix; {short name: [loops]}."""
    res = {}
    for name, insns in sorted(functions(lib).items()):
        short = short_name(name)
        res[short] = inner_loops(insns)
        for lp in res[short]:
            c = lp["counts"]
            pairs = c["MUFU.RCP"]
            per = (lambda k: f"{c[k] / pairs:.2f}") if pairs else \
                (lambda k: "n/a")
            h = lp["head"]
            print(f"{tag} {Path(lib).name} {short} loop "
                  f"0x{lp['lo']:x}-0x{lp['hi']:x}: {lp['n']} instructions, "
                  f"{c['FFMA']} FFMA, {c['LDS']} LDS, {c['MUFU.RCP']} "
                  f"MUFU.RCP, {c['other']} other; pairs per iteration "
                  f"{pairs}; per pair FFMA {per('FFMA')}, LDS {per('LDS')}, "
                  f"other {per('other')} (+{per('MUFU.RCP')} MUFU.RCP); "
                  f"head to the first branch {lp['head_n']} instructions: "
                  f"{h['FFMA']} FFMA, {h['LDS']} LDS, "
                  f"{h['MUFU.RCP'] + h['other']} other", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("libs", nargs="*", help="built kernel libraries (.so)")
    args = ap.parse_args(argv)
    libs = args.libs
    if not libs:
        from fovtrace_torch.kernels import cluster_isect as ci
        libs = [ci.load_cuda_library()._name]
    for lib in libs:
        report(lib)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
