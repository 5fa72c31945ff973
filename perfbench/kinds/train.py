"""Training cells: the port's ``make_train_step(cfg)`` step, driven
from the seed.

Set-up draws the weights on the device, builds the step with its
optimizer state and drives it through the mix's ``checked_steps``
steps, through the window's own call and feed (a new batch a step):
they warm up every shape, and their loss, step 1's gradient (read from
the first moment, ``m = (1 - b1) · g`` as the optimizer got it) and the
change they made to each leaf are what the reference checks. The window
then runs whole steps on that same object until ``--seconds`` have
passed and synchronises once. ``train_tokens_per_s`` is the tokens of
all those steps over the host's wall from the first step's start to
that synchronisation.

With ``--trace 1`` the step's phase hook (``mark``) records CUDA events
in every window step, and ``torch.profiler`` traces ``trace_steps``
steps of the window after its first; the phase times are read from the
steps it does not trace.

After the window the program's state is freed and the reference
(``reference/<family>.py``) works the checked steps out again from the
same weights and batches, in float32.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace
from typing import Dict, List

from perfbench.harness import compare, device as dev_mod, program, weights
from perfbench.harness.check import judge
from perfbench.harness.stats import rate
from perfbench.harness.trace import DeviceTrace
from perfbench.harness.traffic import Batches
from perfbench.reference.layers import key


class Marks:
    """The step's phase hook: (phase, CUDA event or host time) as each
    phase begins; :meth:`phases` gives each step's milliseconds a
    phase."""

    def __init__(self, torch, device: str):
        self.torch, self.device = torch, device
        self.log: List = []

    def __call__(self, name: str) -> None:
        if self.device == "cuda":
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.log.append((name, ev))

    def _ms(self, a, b) -> float:
        if self.device == "cuda":
            return a.elapsed_time(b)
        return (b - a) * 1e3

    def phases(self) -> List[Dict[str, float]]:
        """Per step (a step ends at the "end" after "optimizer"): the
        summed ms of each phase over the step's microbatches, and
        ``step``, from the step's first mark to its last."""
        steps, cur, first = [], {}, None
        for (name, ev), (_, nxt) in zip(self.log, self.log[1:]):
            first = ev if first is None else first
            if name != "end":
                cur[name] = cur.get(name, 0.0) + self._ms(ev, nxt)
            if name == "optimizer":
                cur["step"] = self._ms(first, nxt)
                steps.append(cur)
                cur, first = {}, None
            elif name == "end" and first is ev:
                first = None
        return steps


def leaf_at(tree, path):
    for key in path:
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) \
            and not hasattr(tree, "_fields") else tree[key]
    return tree


def sq_norm(t) -> float:
    """Σ t² in float32, a slice of the leading dim at a time."""
    parts = t if t.dim() >= 3 else [t]
    return sum(float(p.float().square().sum()) for p in parts)


def change_norms(params, config, seed, device) -> Dict[str, float]:
    """Each leaf's ‖p − p0‖, p0 drawn again from the seed."""
    start = weights.make(config, seed, device)
    out = {}
    for path, p0 in start.items():
        p = leaf_at(params, path)
        out[key(path)] = math.sqrt(sum(
            float((a.float() - b.float()).square().sum())
            for a, b in zip(p if p.dim() >= 3 else [p],
                            p0 if p0.dim() >= 3 else [p0])))
    return out


def setup(r) -> SimpleNamespace:
    """Weights, optimizer state and step built on the device, and the
    checked steps run: their losses, step 1's gradient norm a leaf and
    each leaf's change after them."""
    torch = r.torch
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_loop

    t, m, device = r.traffic, r.model, r.device
    p = SimpleNamespace()
    cfg = program.arch_config(m)
    opt_cfg = opt_mod.AdamWConfig(**t["optimizer"])
    p.marks = Marks(torch, device)
    flat = weights.make(r.config, r.seed, device)
    paths = list(flat)
    p.params = weights.as_tree(flat)
    del flat
    p.opt_state = opt_mod.init_opt_state(p.params, opt_cfg)
    p.step = train_loop.make_train_step(cfg, opt_cfg,
                                        mark=p.marks if r.trace else None)
    p.feed = Batches(t, r.seed, m["vocab"], device, torch)
    p.losses, p.grad1 = [], {}
    for i in range(t["checked_steps"]):
        p.params, p.opt_state, met = p.step(p.params, p.opt_state,
                                            p.feed.next())
        p.losses.append(float(met["loss"]))
        if i == 0:
            p.grad1 = {key(q): math.sqrt(sq_norm(
                leaf_at(p.opt_state.m, q).payload)) / (1 - opt_cfg.b1)
                for q in paths}
    p.change = change_norms(p.params, r.config, r.seed, device)
    dev_mod.free(torch, device)
    dev_mod.synchronize(torch, device)
    return p


def run(r) -> Dict:
    torch, t, device = r.torch, r.traffic, r.device
    p = setup(r)

    # the window: whole steps on the same object
    p.marks.log.clear()
    tracer = DeviceTrace(torch)
    traced = (1, 1 + t["trace_steps"]) if r.trace and device == "cuda" \
        else (-1, -1)
    if traced[0] >= 0:
        tracer.warm()
    window_losses, n = [], 0
    t_w0 = time.perf_counter()
    while True:
        if n == traced[0]:
            tracer.start()
        with tracer.span("train_step"):
            p.params, p.opt_state, met = p.step(p.params, p.opt_state,
                                                p.feed.next())
        window_losses.append(met["loss"])
        n += 1
        if n == traced[1]:
            tracer.stop()
        if time.perf_counter() - t_w0 >= r.seconds:
            break
    if tracer.active:
        tracer.stop()
    dev_mod.synchronize(torch, device)
    wall = time.perf_counter() - t_w0
    setup_s = t_w0 - r.t0
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    peak = dev_mod.peak_bytes(torch, device)
    counts = program.counters()
    # the phase times of the steps outside the traced ones
    phases = [ph for i, ph in enumerate(p.marks.phases())
              if not traced[0] <= i < traced[1]]
    summary = tracer.summary() if traced[0] >= 0 else {}
    losses, grad1, change = p.losses, p.grad1, p.change
    del p, met, window_losses
    dev_mod.free(torch, device)

    # the reference, from the same weights and batches
    ref = reference_steps(r)
    readings = compare_steps(losses, grad1, change, ref)
    correct, checks = judge(readings, r.limits["limits"])
    tokens = n * t["batch"] * t["seq_len"]
    return {
        "correct": correct, "checks": checks, "attempted": n,
        "failed": failed,
        "e2e": {"train_tokens_per_s": rate(tokens, wall), "setup_s": setup_s},
        "peak": peak, "counters": counts,
        "obs": {"model": r.model, "traffic": t, "phases": phases,
                "trace": summary},
        "trace": summary,
    }


def reference_steps(r, precision="float32", rows=None) -> Dict:
    """The reference's checked steps from the seed's weights and batches
    (in ``precision``; with ``rows``, each batch cut to its first rows,
    the mean taken over them: the half-batch fault)."""
    from perfbench.reference.layers import highest_precision

    highest_precision()
    t, m = r.traffic, r.model
    feed = Batches(t, r.seed, m["vocab"], r.device, r.torch)
    batches = [feed.next() for _ in range(t["checked_steps"])]
    micro = m["microbatch"]
    if rows is not None:
        batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
        micro = max(1, micro * rows // t["batch"])
    start = weights.make(r.config, r.seed, r.device)
    return r.reference().train(start, m, batches, t["optimizer"], micro,
                               precision)


def compare_steps(losses, grad1, change, ref) -> Dict[str, float]:
    """The numbers compared: the largest gap of a checked step's loss,
    and by the worst leaf the gap of step 1's gradient norm (as
    clipped) and of the change's norm (over the leaves the reference's
    gradient moves), each against the reference's ``ref``."""
    return {
        "loss_gap": max(compare.rel_gap(a, b)
                        for a, b in zip(losses, ref["losses"])),
        "grad_gap": compare.worst_leaf(grad1, ref["grad_clipped"]),
        "change_gap": compare.worst_leaf(
            change, ref["change"], compare.moving(ref["grad_raw"])),
    }
