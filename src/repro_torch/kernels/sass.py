"""Count the SASS instructions of the kernels' loops: a static proxy for
the instructions a kernel issues per iteration, where the card has no
profiler.  On a host with the CUDA toolkit:

    python -m repro_torch.kernels.sass [--csrc DIR] [--match REGEX] UNIT.cu...

Each unit of ``DIR`` (this package's ``csrc`` by default, or the sources
of another checkout) is compiled alone with ``build.py``'s flags into a
cubin; ptxas' register and spill figures are kept, and ``cuobjdump
-sass`` is read.  One JSON line per kernel whose demangled name matches
``REGEX``: its registers and spills, its instruction count, and each loop
(a backward branch) with its instruction count, the count less the loops
nested in it (the instructions one iteration issues when those run no
time) and that count by opcode.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

from . import build

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
FUNC = re.compile(r"Function : (\S+)")
PTXAS_ENTRY = re.compile(r"(?:Compiling entry function|Function properties "
                         r"for) '?([^' ]+)'?")
PTXAS_REGS = re.compile(r"Used (\d+) registers")
PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    cand = Path("/usr/local/cuda/bin") / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: this needs the CUDA toolkit")


def demangle(names):
    if not names:
        return {}
    out = subprocess.run([tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return dict(zip(names, out.splitlines()))


def ptxas_figures(log: str) -> dict:
    """Mangled name -> {"registers", "smem_bytes", "spill_stores",
    "spill_loads"}."""
    figs, cur = {}, None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            cur = figs.setdefault(m.group(1), {})
        elif cur is not None:
            m = PTXAS_REGS.search(line)
            if m:
                cur["registers"] = int(m.group(1))
            m = PTXAS_SMEM.search(line)
            if m:
                cur["smem_bytes"] = int(m.group(1))
            m = PTXAS_SPILL.search(line)
            if m:
                cur["spill_stores"] = int(m.group(1))
                cur["spill_loads"] = int(m.group(2))
    return figs


def functions(sass: str) -> dict:
    """Mangled name -> [(address, opcode, text)] without the padding."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = INSN.search(line)
        if m and cur is not None:
            text = m.group(2).strip()
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            if op != "NOP":
                cur.append((int(m.group(1), 16), op, text))
    return funcs


def loops(insns) -> list:
    """Each backward branch's loop (not the trap that branches to itself
    after the exit): its span, size, size less the loops nested in it, and
    that remainder by opcode (without suffixes)."""
    spans = []
    for addr, op, text in insns:
        m = re.search(r"0x([0-9a-f]+)", text)
        if op.split(".")[0] == "BRA" and m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    out = []
    for lo, hi in spans:
        inner = [(a, b) for a, b in spans if lo <= a and b <= hi
                 and (a, b) != (lo, hi)]
        body = [(a, op) for a, op, _ in insns if lo <= a <= hi]
        flat = [op for a, op in body
                if not any(x <= a <= y for x, y in inner)]
        out.append({"start": hex(lo), "end": hex(hi),
                    "instructions": len(body), "flat": len(flat),
                    "ops": dict(Counter(o.split(".")[0]
                                        for o in flat).most_common(16))})
    return out


def count(unit: Path, csrc: Path, match: str):
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / (unit.stem + ".cubin")
        res = subprocess.run(
            [build._nvcc(), *build.ARCH, *build.FLAGS, "-I", str(csrc),
             "-cubin", str(unit), "-o", str(cubin)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {unit}:\n{res.stdout}"
                               f"{res.stderr}")
        figs = ptxas_figures(res.stdout + res.stderr)
        sass = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
    funcs = functions(sass)
    names = demangle(list(funcs))
    for mangled, insns in funcs.items():
        name = names.get(mangled, mangled)
        if not re.search(match, name):
            continue
        yield {"unit": str(unit), "kernel": name, **figs.get(mangled, {}),
               "instructions": len(insns), "loops": loops(insns)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("units", nargs="+", help="translation units (.cu)")
    ap.add_argument("--csrc", type=Path, default=build.CSRC,
                    help="the directory of the units and their headers")
    ap.add_argument("--match", default="",
                    help="keep the kernels whose demangled name matches "
                         "this regex, e.g. 'kernel<\\(int\\)8,'")
    args = ap.parse_args(argv)
    found = 0
    for u in args.units:
        for row in count(args.csrc / u, args.csrc, args.match):
            print(json.dumps(row), flush=True)
            found += 1
    if not found:
        raise SystemExit(f"no kernel matches {args.match!r} (cu++filt "
                         "writes template arguments as <(int)8, ...>)")


if __name__ == "__main__":
    sys.exit(main())
