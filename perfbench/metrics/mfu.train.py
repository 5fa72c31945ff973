"""The whole train step's share of the card's bf16 peak: the model
FLOPs of a step (``counts/<family>.py``: 6 · N · T plus causal
attention, no recomputation) over the mean step time (CUDA events from
the step's first phase mark to its last, over the window's steps the
profiler does not trace), in %."""

from perfbench.harness.peaks import BF16_FLOPS


def read(obs):
    steps = [s["step"] for s in obs.get("phases", []) if "step" in s]
    if not steps:
        return None
    r, t = obs["run"], obs["traffic"]
    flops = r.count(r.config["family"]).train_step_flops(
        obs["model"], t["batch"], t["seq_len"])
    return 100.0 * flops / (sum(steps) / len(steps) * 1e-3) / BF16_FLOPS
