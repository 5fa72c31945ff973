"""Serving cells: the port's ``ServeEngine`` under a closed loop.

``clients`` clients each keep one request in flight: a client submits
its next request the moment its last one finishes (the request's
``submitted_s`` is that moment), and ``ServeEngine.step`` admits it
(one prefill a request) at the next tick. Requests come from
``harness/traffic.py``; greedy decoding, no eos, each request ends after
its answer's length. Every tick's batch is a function of the seed.

Set-up draws the weights on the device, builds the engine, warms up one
prefill at the longest prompt and one tick of all slots, then runs
``prewarm_ticks`` ticks of the loop, so that the window opens on a loop
in its steady state. The window runs whole ticks until ``--seconds``
have passed (each tick ends in the engine's own copy of the next tokens
to the host). With ``--trace 1``, ``torch.profiler`` traces
``trace_seconds`` in the middle of the window; the engine's tick time
and the model FLOPs' rate are read from the ticks it does not trace.

After the window the program's state is freed and the reference runs
over a sample of the requests finished in the window (drawn from the
seed, the longest among them), prompt and served tokens, and reads by
how much each served token's logit lies below its best.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from perfbench.harness import device as dev_mod, program, weights
from perfbench.harness.check import judge
from perfbench.harness.stats import percentile, rate
from perfbench.harness.trace import DeviceTrace
from perfbench.harness.traffic import Requests


class ClosedLoop:
    """The clients around one engine."""

    def __init__(self, engine, requests: Requests, clients: int, tracer):
        self.engine, self.requests, self.tracer = engine, requests, tracer
        self.next_index = 0
        self.pending: List = []       # submitted, not yet prefilled
        self.seen = len(engine.finished)
        self.ticks: List[Dict] = []   # per tick: host s, prefills, decodes,
        #                               whether traced
        for _ in range(clients):
            self.submit(time.perf_counter())

    def submit(self, at: float) -> None:
        from repro_torch.serve.request import Request

        i = self.next_index
        self.next_index += 1
        _, answer = self.requests.sizes(i)
        req = Request(f"r{i}", self.requests.prompt(i), max_tokens=answer,
                      submitted_s=at)
        self.pending.append(req)
        self.engine.add_request(req)

    def tick(self) -> None:
        eng = self.engine
        t0 = time.perf_counter()
        traced = self.tracer.active
        with self.tracer.span("engine.step"):
            eng.step()
        t1 = time.perf_counter()
        with self.tracer.span("client"):
            prefilled = [r for r in self.pending if r.first_token_s]
            self.pending = [r for r in self.pending if not r.first_token_s]
            done = eng.finished[self.seen:]
            self.seen = len(eng.finished)
            # each request decoding this tick: its keys at that decode
            contexts = [len(r.prompt) + len(r.generated) - 1
                        for r in list(eng.active.values()) + done]
            for r in done:
                self.submit(r.finished_s)
        self.ticks.append({"t0": t0, "t1": t1, "t2": time.perf_counter(),
                           "traced": traced,
                           "prefills": [len(r.prompt) for r in prefilled],
                           "ttft_ms": [(r.first_token_s - r.submitted_s)
                                       * 1e3 for r in prefilled],
                           "contexts": contexts})


def run(r) -> Dict:
    torch = r.torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.request import Request

    t, m, device = r.traffic, r.model, r.device
    cfg = program.arch_config(m)
    requests = Requests(t, r.seed, m["vocab"])
    longest = max(p for p, _ in requests.block)
    if cfg.n_experts and not all(program.dropless(cfg, n) for n in
                                 [t["n_slots"]] + [p for p, _ in
                                                   requests.block]):
        raise ValueError("the configuration's capacity drops tokens at "
                         "this mix's shapes")
    params = weights.as_tree(weights.make(r.config, r.seed, device))
    engine = ServeEngine(params, cfg, n_slots=t["n_slots"],
                         max_seq=t["max_seq"], device=device)
    warm = Request("warmup", np.zeros(longest, np.int32), max_tokens=2)
    engine.add_request(warm)
    engine.run_until_done()
    hook = r.options.get("engine_hook")
    if hook is not None:
        hook(engine)
    tracer = DeviceTrace(torch)
    loop = ClosedLoop(engine, requests, t["clients"], tracer)
    for _ in range(t["prewarm_ticks"]):
        loop.tick()
    first_tick = len(loop.ticks)
    tokens0 = engine.tokens_generated
    dev_mod.synchronize(torch, device)

    # the window
    begin = max(0.0, (r.seconds - t["trace_seconds"]) / 2)
    trace = r.trace and device == "cuda"
    if trace:
        tracer.warm()
    t_w0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t_w0
        if trace and not tracer.active and not tracer.rows \
                and now >= begin:
            tracer.start()
            end = time.perf_counter() - t_w0 + t["trace_seconds"]
        loop.tick()
        now = time.perf_counter() - t_w0
        if tracer.active and now >= end:
            tracer.stop()
        if now >= r.seconds:
            break
    t_w1 = loop.ticks[-1]["t1"]
    if tracer.active:
        tracer.stop()
    setup_s = t_w0 - r.t0
    wall = t_w1 - t_w0
    window = loop.ticks[first_tick:]
    finished = [q for q in engine.finished
                if q.request_id != "warmup" and t_w0 <= q.finished_s <= t_w1]
    first = [q for q in engine.finished + list(engine.active.values())
             if q.request_id != "warmup" and q.first_token_s
             and t_w0 <= q.first_token_s <= t_w1]
    prompt_tokens = sum(len(q.prompt) for q in first)
    generated = engine.tokens_generated - tokens0
    ttft = [(q.first_token_s - q.submitted_s) * 1e3 for q in first]
    tpot = [(q.finished_s - q.first_token_s) * 1e3
            / max(1, len(q.generated) - 1) for q in finished]
    wrong_len = sum(len(q.generated) != q.max_tokens for q in finished)
    peak = dev_mod.peak_bytes(torch, device)
    counts = program.counters()
    served = [(q.prompt, list(q.generated)) for q in finished]
    del engine, params, loop.engine
    dev_mod.free(torch, device)

    readings = check_served(r, served,
                            r.options.get("precisions", ("float32",)))
    readings["wrong_lengths"] = float(wrong_len)
    correct, checks = judge(readings, r.limits["limits"])
    steady = [k for k in window if not k["traced"]]
    obs = {"model": m, "traffic": t,
           # the ticks outside the traced stretch
           "tick_s": [k["t1"] - k["t0"] for k in steady],
           "steady_s": sum(k["t2"] - k["t0"] for k in steady),
           "prefills": [n for k in steady for n in k["prefills"]],
           "contexts": [c for k in steady for c in k["contexts"]],
           "traced_prefills": [n for k in window if k["traced"]
                               for n in k["prefills"]]}
    summary = tracer.summary() if trace else {}
    obs["trace"] = summary
    return {
        "correct": correct, "checks": checks, "readings": readings,
        "attempted": len(finished), "failed": wrong_len,
        "e2e": {"serve_tokens_per_s": rate(prompt_tokens + generated, wall),
                "ttft_p95_ms": percentile(ttft, 95),
                "tpot_p95_ms": percentile(tpot, 95),
                "setup_s": setup_s},
        "peak": peak, "counters": counts, "obs": obs, "trace": summary,
        "requests": {"first_tokens": len(first), "finished": len(finished),
                     "ttft_p50_ms": percentile(ttft, 50),
                     "tpot_p50_ms": percentile(tpot, 50)},
        # every tick from the loop's first, warm ticks included
        "ticks": [{"ms": (k["t1"] - k["t0"]) * 1e3, "ttft_ms": k["ttft_ms"],
                   "in_window": i >= first_tick}
                  for i, k in enumerate(loop.ticks)],
    }


def sample(r, served) -> List[int]:
    """Indices of the requests the reference checks: the longest (prompt
    and answer) and ``check_requests - 1`` more drawn from the seed."""
    n = len(served)
    if n == 0:
        return []
    longest = max(range(n), key=lambda i: len(served[i][0])
                  + len(served[i][1]))
    rest = [i for i in range(n) if i != longest]
    rng = np.random.default_rng(weights.derive(r.seed, "check"))
    k = min(len(rest), r.traffic["check_requests"] - 1)
    return [longest] + sorted(rng.choice(rest, k, replace=False).tolist())


def check_served(r, served, precisions=("float32",)) -> Dict[str, float]:
    """``widest_gap``: the largest amount by which a served token's
    logit, in the reference, lies below the reference's best at its
    position, over the sampled requests (and, for each further
    precision, ``widest_gap.<precision>``: the same of the token that
    precision puts first: the control)."""
    torch = r.torch
    ref = r.reference()
    from perfbench.reference.layers import highest_precision, named

    highest_precision()
    w = named(weights.make(r.config, r.seed, r.device))
    gaps = {p: [] for p in precisions}
    picked = sample(r, served)
    for i in picked:
        prompt, gen = served[i]
        seq = np.concatenate([prompt, np.asarray(gen[:-1], np.int32)])
        tokens = torch.as_tensor(seq, device=r.device).long()
        at = range(len(prompt) - 1, len(prompt) - 1 + len(gen))
        lg = ref.logits_at(w, r.model, tokens, at, precisions)
        base = lg["float32"]
        best = base.max(-1).values
        for prec in precisions:
            tok = torch.as_tensor(gen, device=r.device) \
                if prec == "float32" else lg[prec].argmax(-1)
            tok = tok.long()
            valid = (tok >= 0) & (tok < base.shape[1])
            got = base.gather(1, tok.clamp(0, base.shape[1] - 1)[:, None])
            # a token outside the vocabulary lies infinitely far below
            gap = torch.where(valid, best - got[:, 0], float("inf"))
            gaps[prec] += gap.tolist()
    out = {}
    for prec, g in gaps.items():
        tag = "" if prec == "float32" else f".{prec}"
        out["widest_gap" + tag] = max(g) if g else float("nan")
        out["mean_gap" + tag] = sum(g) / len(g) if g else float("nan")
    return out
