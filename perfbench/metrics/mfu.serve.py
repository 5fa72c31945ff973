"""The served model's share of the card's bf16 peak: the model FLOPs of
every prefill and every decoded token (``counts/<family>.py``) over the
host's seconds of the ticks that carried them (the window's ticks the
profiler does not trace), in %."""

from perfbench.harness.peaks import BF16_FLOPS


def read(obs):
    if not obs.get("steady_s") or not obs.get("contexts"):
        return None
    r, m = obs["run"], obs["model"]
    c = r.count(r.config["family"])
    flops = sum(c.prefill_flops(m, s) for s in obs["prefills"]) \
        + sum(c.decode_flops(m, k) for k in obs["contexts"])
    return 100.0 * flops / obs["steady_s"] / BF16_FLOPS
