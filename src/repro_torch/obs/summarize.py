"""Trace analyzer: ``python -m repro_torch.obs.summarize trace.json``.

Reads a Chrome-trace JSON produced by :func:`repro_torch.obs.
export_chrome_trace` and renders the text instrument panel:

  * compile-pipeline stage totals per kernel (parse → SCoP →
    dependence → schedule → fusion → codegen → cache-store);
  * per-phase head totals across all pfor rounds (plan / split /
    dispatch / ship / gather / merge) with their share of round wall;
  * per-worker utilization — busy vs idle % over the traced rounds,
    split by span kind (run / restore / diff / deserialize);
  * the **critical path of each pfor round**: the head phase chain,
    descending into the last-finishing chunk (the one that gated the
    gather) and its worker-side breakdown;
  * a direct dominant-phase statement, e.g.
    ``gather on head = 61% of round wall``.

``--json`` emits the same summary machine-readable (CI asserts on it).
Exit status: 0 on success, 2 on a malformed/unreadable trace.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional

HEAD_PHASES = ("plan", "split", "dispatch", "ship", "gather", "merge")
WORKER_KINDS = ("deserialize", "restore", "run", "diff")


def _dur_s(ev: Dict[str, Any]) -> float:
    return float(ev.get("dur", 0.0)) / 1e6


def _args(ev: Dict[str, Any]) -> Dict[str, Any]:
    return ev.get("args") or {}


def load_events(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError("traceEvents is not a list")
    return [ev for ev in events if ev.get("ph") == "X"]


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    rounds = [ev for ev in events if ev["name"] == "pfor_round"]
    phase_evs = [ev for ev in events if ev.get("cat") == "pfor"
                 and ev["name"] in HEAD_PHASES]
    chunk_evs = [ev for ev in events if ev["name"] == "chunk_inflight"]
    worker_evs = [ev for ev in events if ev.get("cat") == "worker"]
    compile_evs = [ev for ev in events if ev.get("cat") == "compile"]

    out: Dict[str, Any] = {}

    # -- compile pipeline ---------------------------------------------------
    compile_stages: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    for ev in compile_evs:
        kernel = _args(ev).get("kernel", "?")
        compile_stages[kernel][ev["name"]] += _dur_s(ev)
    out["compile"] = {k: dict(v) for k, v in compile_stages.items()}

    # -- head phase totals --------------------------------------------------
    round_wall = sum(_dur_s(ev) for ev in rounds)
    phases: Dict[str, float] = defaultdict(float)
    for ev in phase_evs:
        phases[ev["name"]] += _dur_s(ev)
    out["rounds_traced"] = len(rounds)
    out["round_wall_s"] = round(round_wall, 6)
    out["phases"] = {
        name: {"total_s": round(total, 6),
               "share_of_round_wall": (round(total / round_wall, 4)
                                       if round_wall > 0 else None)}
        for name, total in sorted(phases.items(),
                                  key=lambda kv: -kv[1])}

    # -- per-worker utilization --------------------------------------------
    workers: Dict[str, Dict[str, Any]] = {}
    for ev in worker_evs:
        wid = _args(ev).get("wid")
        key = f"w{wid}" if wid is not None else \
            f"pid{ev['pid']}.tid{ev['tid']}"
        w = workers.setdefault(key, {"busy_s": 0.0, "spans": 0,
                                     **{f"{k}_s": 0.0
                                        for k in WORKER_KINDS},
                                     "run_spans": 0})
        d = _dur_s(ev)
        w["busy_s"] += d
        w["spans"] += 1
        if ev["name"] in WORKER_KINDS:
            w[f"{ev['name']}_s"] += d
        if ev["name"] == "run":
            w["run_spans"] += 1
    for w in workers.values():
        for k in list(w):
            if k.endswith("_s"):
                w[k] = round(w[k], 6)
        if round_wall > 0:
            w["busy_pct"] = round(100.0 * w["busy_s"] / round_wall, 1)
            w["idle_pct"] = round(100.0 - min(100.0, w["busy_pct"]), 1)
    out["workers"] = dict(sorted(workers.items()))

    # -- critical path per round -------------------------------------------
    crits: List[Dict[str, Any]] = []
    for ev in sorted(rounds, key=lambda e: _args(e).get("round", 0)):
        rid = _args(ev).get("round")
        wall = _dur_s(ev)
        if wall <= 0:
            continue
        rp = {p["name"]: _dur_s(p) for p in phase_evs
              if _args(p).get("round") == rid}
        chunks = [c for c in chunk_evs if _args(c).get("round") == rid]
        crit: Dict[str, Any] = {
            "round": rid, "unit": _args(ev).get("unit"),
            "wall_s": round(wall, 6),
            "phases_pct": {n: round(100.0 * d / wall, 1)
                           for n, d in sorted(rp.items(),
                                              key=lambda kv: -kv[1])},
        }
        if chunks:
            # the chunk that finished last gated the gather: descend
            # into its worker spans for the path below the head
            last = max(chunks, key=lambda c: c["ts"] + c["dur"])
            la = _args(last)
            wspans = [w for w in worker_evs
                      if _args(w).get("task") == la.get("task")]
            on_worker = sum(_dur_s(w) for w in wspans)
            crit["gating_chunk"] = {
                "task": la.get("task"), "lo": la.get("lo"),
                "hi": la.get("hi"), "wid": la.get("wid"),
                "backend": la.get("backend"),
                "inflight_s": round(_dur_s(last), 6),
                "inflight_pct_of_wall": round(
                    100.0 * _dur_s(last) / wall, 1),
                "on_worker": {w["name"]: round(_dur_s(w), 6)
                              for w in wspans},
                "queue_ship_wait_s": round(
                    max(0.0, _dur_s(last) - on_worker), 6),
            }
        crits.append(crit)
    out["critical_paths"] = crits

    # -- dominant phase -----------------------------------------------------
    if phases and round_wall > 0:
        name, total = max(phases.items(), key=lambda kv: kv[1])
        out["dominant"] = {
            "phase": name, "total_s": round(total, 6),
            "pct_of_round_wall": round(100.0 * total / round_wall, 1),
            "statement": (f"{name} on head = "
                          f"{100.0 * total / round_wall:.0f}% of round "
                          f"wall ({len(rounds)} round(s) traced)"),
        }
    return out


def render(s: Dict[str, Any]) -> str:
    lines: List[str] = []
    if s["compile"]:
        lines.append("== compile pipeline ==")
        for kernel, stages in s["compile"].items():
            stage_txt = " | ".join(
                f"{n} {d * 1e3:.1f}ms"
                for n, d in sorted(stages.items(), key=lambda kv: -kv[1]))
            lines.append(f"  {kernel}: {stage_txt}")
    lines.append(f"== head phases ({s['rounds_traced']} pfor round(s), "
                 f"wall {s['round_wall_s'] * 1e3:.1f}ms) ==")
    for name, row in s["phases"].items():
        share = row["share_of_round_wall"]
        pct = f"{share * 100:.1f}%" if share is not None else "n/a"
        lines.append(f"  {name:<9} {row['total_s'] * 1e3:9.2f}ms  "
                     f"{pct:>6} of round wall")
    lines.append("== workers ==")
    for key, w in s["workers"].items():
        util = (f"busy {w.get('busy_pct', 0.0):.1f}% / "
                f"idle {w.get('idle_pct', 0.0):.1f}%"
                if "busy_pct" in w else f"busy {w['busy_s'] * 1e3:.1f}ms")
        lines.append(
            f"  {key:<6} {util}  "
            f"(run {w['run_spans']}x {w['run_s'] * 1e3:.1f}ms, "
            f"restore {w['restore_s'] * 1e3:.1f}ms, "
            f"diff {w['diff_s'] * 1e3:.1f}ms)")
    if s["critical_paths"]:
        lines.append("== critical path per round ==")
        for c in s["critical_paths"]:
            phase_txt = " -> ".join(f"{n} {p:.0f}%"
                                    for n, p in c["phases_pct"].items())
            lines.append(f"  round {c['round']} "
                         f"({c['wall_s'] * 1e3:.1f}ms): {phase_txt}")
            g = c.get("gating_chunk")
            if g:
                on_w = ", ".join(f"{n} {d * 1e3:.1f}ms"
                                 for n, d in g["on_worker"].items())
                lines.append(
                    f"    gated by chunk [{g['lo']},{g['hi']}) on "
                    f"w{g['wid']} ({g['backend']}): in-flight "
                    f"{g['inflight_pct_of_wall']:.0f}% of wall — "
                    f"{on_w or 'no worker spans'}; queue/ship wait "
                    f"{g['queue_ship_wait_s'] * 1e3:.1f}ms")
    if "dominant" in s:
        lines.append(f"== diagnosis ==")
        lines.append(f"  {s['dominant']['statement']}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.summarize",
        description="Summarize a repro_torch.obs Chrome trace")
    ap.add_argument("trace", help="trace JSON path")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON")
    args = ap.parse_args(argv)
    try:
        events = load_events(args.trace)
        s = summarize(events)
    except (OSError, ValueError, KeyError, TypeError) as exc:
        print(f"summarize: bad trace {args.trace!r}: {exc}",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(s, indent=1))
    else:
        print(render(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
