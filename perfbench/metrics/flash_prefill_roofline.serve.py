"""The flash-attention prefill's share of its roofline in the traced
stretch: the bound of each prefill's calls (``counts/flash_fwd.py``:
one a layer, causal over the prompt) over the device time of the
forward's tensor-core kernel (which decode does not run), in %."""

from perfbench.harness.peaks import bound_s
from perfbench.harness.trace import kernel_time
from perfbench.harness.weights import head_dim


def read(obs):
    r, m = obs["run"], obs["model"]
    ff = r.count("flash_fwd")
    calls, secs = kernel_time(obs.get("trace", {}), ff.KERNELS)
    lens = obs.get("traced_prefills", [])
    if not calls or secs <= 0 or calls != len(lens) * m["layers"]:
        return None
    h, kvh = m["n_heads"], m["kv_heads"]
    d = head_dim(m)
    bound = sum(bound_s(ff.flops(1, s, s, h, d),
                        ff.nbytes(1, s, s, h, kvh, d)) for s in lens)
    return 100.0 * m["layers"] * bound / secs
