"""Where each shared-memory store of the scan backward's kernels lands,
read from the PTX that nvcc makes of ``csrc/mamba_scan_bwd.cu``.

    PYTHONPATH=src python3 -m repro_torch.kernels.mamba_scan.ptx_check \\
        [--double-mini-steps K]

nvcc compiles the source to PTX with the build's flags (with
``--double-mini-steps``, a copy under ``build/ptx_check/`` whose float64
kernels take mini-blocks of K steps). For every instantiation of both
kernels and a few threads, each ``st.shared`` after the block has staged
its chunk (the kernel's second barrier) is evaluated on the first trip of
its loops: the chain of integer instructions (mov, cvt, add, sub, mul,
mad, shl, shr, and, or, xor, bfi, bfe, min, max) from ``%tid.x`` and the
shared array's base. The address is placed in the layout that the
source describes. ``scan_bwd_f64_kernel`` (``smem_bytes``): the comb
slots, the staged tiles of x, dt, dy, B and C (read only once staged),
the mini-blocks' states (each thread writes its own warp's, in its own
lane's column), the sums, or past the end of the block's shared memory.
``scan_bwd_kernel`` (float and bf16, ``smem32_floats``): the staged B and
C rows, the mini-blocks' states (its own warp's area, its own lane's
column), a segment's staged dt, x, dy (its own warp's), the dB/dC slots
(its own warp's), or past the end. One
JSON line an instantiation; exit status 1 if a store lands in a staged
tile or row, in another warp's or lane's place, or outside. No card is
needed, only nvcc. Nothing here runs at import time.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .. import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan_bwd.cu"
HEADER = SOURCE.with_name("mamba_scan.cuh")
# (mangled dtype prefix, dtype name, bytes of T, bytes of the accumulator)
TYPES = (("IddLi", "float64", 8, 8),)
# the float kernel's: (mangled dtype prefix, dtype name)
TYPES32 = (("IfLi", "float32"), ("I13__nv_bfloat16Li", "bfloat16"))
STATE_SIZES = (1, 4, 16, 32)
THREADS = (0, 37, 63, 100)
# the float kernel's 8 warps: threads of the first, middle and last
THREADS32 = (0, 37, 63, 100, 161, 255)
_MINI = "constexpr int MINI_STEPS = 2;"

_DEF = re.compile(r"\s*(@!?%p\d+\s+)?([a-z][\w.]*)\s+(%r\w+|%rd\w+),\s*(.*);")
_STORE = re.compile(r"st\.shared\.\w+\s+\[(%r\w+)([+-]\d+)?\]")
_SKIP = ("ld.", "st.", "atom", "shfl", "setp", "selp", "bar", "cvta")


def constants(source: str, header: str) -> Dict[str, int]:
    """LANES, WARPS, SUB of the header; the float64 kernel's mini-block
    steps, the float kernel's channels a warp, warps a block and
    mini-block steps by state size, of the source."""
    out = {k: int(re.search(rf"constexpr int {k} = (\d+);", header)[1])
           for k in ("LANES", "WARPS", "SUB")}
    out["K_double"] = int(re.search(r"constexpr int MINI_STEPS = (\d+);",
                                    source)[1])
    for k in ("WCH", "BWARPS"):
        found = re.search(rf"constexpr int {k} = (\d+);", source)
        if found:
            out[k] = int(found[1])
    m = re.search(r"return NS <= 4 \? (\d+) : (\d+);", source)
    if m:
        out["K32"] = {1: int(m[1]), 4: int(m[1]), 16: int(m[2]),
                      32: int(m[2])}
    return out


def layout(c: Dict[str, int], t_bytes: int, acc: int, ns: int
           ) -> Tuple[Dict[str, int], int, int]:
    """(byte offsets of the dynamic shared memory's parts, states a
    pass, mini-block states kept a warp): the source's smem_bytes."""
    lanes, warps = c["LANES"], c["WARPS"]
    lc = warps * c["SUB"]
    ng = min(ns, 4)                                  # pass_states
    split = ng < ns
    k = c["K_double"]
    kept = c["SUB"] // k - 1
    off = {"comb": 0}
    off["tiles"] = (warps + 2 + split) * (ns + 1) * lanes * acc
    off["bc"] = off["tiles"] + 3 * lc * lanes * t_bytes
    off["states"] = off["bc"] + 2 * lc * ns * acc
    off["sums"] = off["states"] + warps * kept * ng * lanes * acc
    off["end"] = off["sums"] + split * 2 * lc * lanes * acc
    return off, ng, kept


def kernels(ptx: str) -> Dict[str, List[str]]:
    """The lines of each ``.entry`` of the PTX, by mangled name."""
    out, name = {}, None
    for line in ptx.splitlines():
        if line.startswith(".entry") or line.startswith(".visible .entry"):
            name = line.split()[-1].split("(")[0]
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


class _Eval:
    """Integer values of a kernel's registers on the first trip of its
    loops, for one thread."""

    def __init__(self, lines: List[str], tid: int):
        self.lines, self.tid = lines, tid
        self.defs: Dict[str, List[Tuple[int, str, List[str]]]] = {}
        for i, line in enumerate(lines):
            m = _DEF.match(line)
            if m and not m[2].startswith(_SKIP):
                self.defs.setdefault(m[3], []).append(
                    (i, m[2], [a.strip() for a in m[4].split(",")]))

    def value(self, tok: str, before: int) -> int:
        if re.fullmatch(r"-?\d+", tok):
            return int(tok)
        if re.fullmatch(r"0[xX][0-9a-fA-F]+", tok):
            return int(tok, 16)
        if tok == "%tid.x":
            return self.tid
        if tok == "%ctaid.x":
            return 0
        if not tok.startswith("%"):
            return 0                         # the shared array's base
        # the last definition before the use that does not read the
        # register itself: a loop's entry value, not its update
        cands = [d for d in self.defs.get(tok, ()) if d[0] < before]
        cands = [d for d in cands if tok not in d[2]] or cands
        if not cands:
            raise KeyError(f"no definition of {tok} before line {before}")
        i, op, args = cands[-1]
        a = [self.value(x, i) for x in args]
        o = op.split(".")[0]
        if o in ("mov", "cvt"):
            return a[0]
        if o in ("add", "sub", "mul", "mad", "shl", "and", "or", "xor",
                 "min", "max", "neg"):
            return {"add": lambda: a[0] + a[1], "sub": lambda: a[0] - a[1],
                    "mul": lambda: a[0] * a[1],
                    "mad": lambda: a[0] * a[1] + a[2],
                    "shl": lambda: a[0] << a[1], "and": lambda: a[0] & a[1],
                    "or": lambda: a[0] | a[1], "xor": lambda: a[0] ^ a[1],
                    "min": lambda: min(a[0], a[1]),
                    "max": lambda: max(a[0], a[1]),
                    "neg": lambda: -a[0]}[o]()
        if o == "shr":
            return a[0] >> a[1] if ".s" in op else (a[0] % 2 ** 64) >> a[1]
        if o == "bfe":
            v = (a[0] % 2 ** 64) >> a[1] & ((1 << a[2]) - 1)
            if ".s" in op and a[2] and v >> (a[2] - 1) & 1:
                v -= 1 << a[2]
            return v
        if o == "bfi":
            mask = ((1 << a[3]) - 1) << a[2]
            return (a[1] & ~mask) | ((a[0] << a[2]) & mask)
        raise KeyError(f"{op} at line {i}")


def classify(lines: List[str], off: Dict[str, int], ng: int, kept: int,
             acc: int, lanes: int = 32,
             threads=THREADS) -> Tuple[Dict[str, int], List]:
    """(stores by place, the wrong ones as (line, thread, byte offset,
    place)) of one kernel's shared stores after its second barrier."""
    bars = [i for i, line in enumerate(lines) if "bar.sync" in line]
    places: Dict[str, int] = {}
    wrong = []
    for tid in threads:
        ev = _Eval(lines, tid)
        warp, lane = divmod(tid, lanes)
        own = off["states"] + warp * kept * ng * lanes * acc
        for i in range(bars[1] + 1 if len(bars) > 1 else 0, len(lines)):
            m = _STORE.search(lines[i])
            if not m:
                continue
            a = ev.value(m[1], i) + int(m[2] or 0)
            column = a % (lanes * acc) == lane * acc
            if not 0 <= a < off["end"]:
                place = "outside"
            elif a < off["tiles"]:
                place = "comb" if column else "comb, another lane"
            elif a < off["states"]:
                place = "staged tiles"
            elif a < off["sums"]:
                place = ("states" if own <= a < own + kept * ng * lanes * acc
                         and (a - off["states"]) % (lanes * acc)
                         == lane * acc else "states, another warp or lane")
            else:
                place = "sums" if column else "sums, another lane"
            places[place] = places.get(place, 0) + 1
            if place not in ("comb", "states", "sums"):
                wrong.append((i, tid, a, place))
    return places, wrong


def layout32(c: Dict[str, int], ns: int) -> Tuple[Dict[str, int], int, int]:
    """(byte offsets of the float kernel's dynamic shared memory's parts,
    states a lane, mini-block steps): the source's smem32_floats."""
    lanes, bwarps, wch, sub = c["LANES"], c["BWARPS"], c["WCH"], c["SUB"]
    lc = c["WARPS"] * sub
    s = ns // 4 if ns >= 4 else 1                      # lane_states
    k = c["K32"][ns]
    area = max(sub // k * 2 * s * lanes, 2 * lc * wch)  # warp_area
    off = {"rows": 0}
    off["areas"] = 4 * (2 * lc * 4 * s)
    off["staging"] = off["areas"] + 4 * bwarps * area
    off["slots"] = off["staging"] + 4 * bwarps * 3 * sub * wch
    off["end"] = off["slots"] + 4 * bwarps * sub * 8 * s
    return off, s, k


def classify32(lines: List[str], off: Dict[str, int], s: int, k: int,
               lanes: int = 32, bwarps: int = 8,
               threads=THREADS32) -> Tuple[Dict[str, int], List]:
    """(stores by place, the wrong ones as (line, thread, byte offset,
    place)) of the float kernel's shared stores after its second
    barrier (``k`` its mini-block's steps): a mini-block state in its own
    warp's area and its own lane's column, a staged value in its own
    warp's staging, a dB/dC sum in its own warp's slots."""
    bars = [i for i, line in enumerate(lines) if "bar.sync" in line]
    per = {part: (off[nxt] - off[part]) // bwarps for part, nxt in
           (("areas", "staging"), ("staging", "slots"), ("slots", "end"))}
    places: Dict[str, int] = {}
    wrong = []
    for tid in threads:
        ev = _Eval(lines, tid)
        warp, lane = divmod(tid, lanes)
        for i in range(bars[1] + 1 if len(bars) > 1 else 0, len(lines)):
            m = _STORE.search(lines[i])
            if not m:
                continue
            a = ev.value(m[1], i) + int(m[2] or 0)
            if not 0 <= a < off["end"]:
                place = "outside"
            elif a < off["areas"]:
                place = "staged rows"
            else:
                part = ("areas" if a < off["staging"] else "staging"
                        if a < off["slots"] else "slots")
                own = (a - off[part]) // per[part] == warp
                column = (a - off["areas"]) % (lanes * 4) == lane * 4
                name = "states" if part == "areas" else part
                place = (name if own and (part != "areas" or column)
                         else f"{name}, another warp or lane")
            places[place] = places.get(place, 0) + 1
            if place not in ("states", "staging", "slots"):
                wrong.append((i, tid, a, place))
    return places, wrong


def check(ptx: str, c: Dict[str, int]) -> List[dict]:
    """One record an instantiation of ``scan_bwd_f64_kernel`` and of
    ``scan_bwd_kernel``."""
    out = []
    found = kernels(ptx)

    def one(kernel, prefix, ns):
        names = [n for n in found if f"{kernel}{prefix}{ns}E" in n]
        if len(names) != 1:
            raise KeyError(f"{kernel}{prefix}{ns}: {names}")
        return found[names[0]]

    for prefix, dname, t_bytes, acc in TYPES:
        for ns in STATE_SIZES:
            off, ng, kept = layout(c, t_bytes, acc, ns)
            places, wrong = classify(one("scan_bwd_f64_kernel", prefix, ns),
                                     off, ng, kept, acc, c["LANES"])
            out.append({"kernel": "scan_bwd_f64_kernel", "dtype": dname,
                        "ns": ns, "mini_steps": c["K_double"],
                        "smem_bytes": off["end"], "stores": places,
                        "wrong": [[i, t, hex(a), p]
                                  for i, t, a, p in wrong[:6]],
                        "n_wrong": len(wrong)})
    for prefix, dname in TYPES32:
        for ns in STATE_SIZES:
            off, s, k = layout32(c, ns)
            places, wrong = classify32(one("scan_bwd_kernel", prefix, ns),
                                       off, s, k, c["LANES"], c["BWARPS"])
            out.append({"kernel": "scan_bwd_kernel", "dtype": dname,
                        "ns": ns, "mini_steps": k, "smem_bytes": off["end"],
                        "stores": places,
                        "wrong": [[i, t, hex(a), p]
                                  for i, t, a, p in wrong[:6]],
                        "n_wrong": len(wrong)})
    return out


def ptx_of(source: Path) -> str:
    """The PTX of ``source`` with the build's flags, by nvcc."""
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    out = source.with_suffix(".ptx")
    includes = [f"-I{inc}" for inc in (SOURCE.parent, _build.SHARED_INCLUDE)]
    subprocess.run([_build._nvcc(), *flags, *includes, "-ptx", "-o",
                    str(out), str(source)], check=True)
    return out.read_text()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--double-mini-steps", type=int, default=None,
                    help="check a copy whose double kernels take "
                         "mini-blocks of this many steps")
    args = ap.parse_args(argv)
    source = SOURCE.read_text()
    if args.double_mini_steps:
        if _MINI not in source:
            raise SystemExit("mini_steps() is not the expected line")
        source = source.replace(
            _MINI, f"constexpr int MINI_STEPS = {args.double_mini_steps};")
    work = _build.ROOT / "build" / "ptx_check"
    work.mkdir(parents=True, exist_ok=True)
    copy = work / (f"mamba_scan_bwd_k{args.double_mini_steps or 0}.cu")
    copy.write_text(source)
    records = check(ptx_of(copy), constants(source, HEADER.read_text()))
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 1 if any(r["n_wrong"] for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
