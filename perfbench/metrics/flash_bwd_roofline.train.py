"""The flash-attention backward's share of its roofline in the traced
steps: the bound of its calls (``counts/flash_bwd.py``, each the
training shape: one microbatch's rows times the heads, the sequence,
head_dim) over the device time of its kernels, in %."""

from perfbench.harness.peaks import bound_s
from perfbench.harness.trace import kernel_time
from perfbench.harness.weights import head_dim


def read(obs):
    r, t, m = obs["run"], obs["traffic"], obs["model"]
    fb = r.count("flash_bwd")
    calls, _ = kernel_time(obs.get("trace", {}), (fb.CALL_KERNEL,))
    _, secs = kernel_time(obs.get("trace", {}), fb.KERNELS)
    if not calls or secs <= 0:
        return None
    bh = t["batch"] // m["microbatch"] * m["n_heads"]
    d = head_dim(m)
    s = t["seq_len"]
    bound = bound_s(fb.flops(bh, s, d), fb.nbytes(bh, s, d))
    return 100.0 * calls * bound / secs
