"""One rank of the sharded-ops check (``test_torch_dryrun.py`` starts
four): the flash attention and selective scan ops on DTensor inputs
over a (2, 2) ``gloo`` mesh, forward and gradient, against the same ops
on the whole tensors. Rank 0 writes each case's largest absolute error
and the ranks' sharded-call counts as JSON.

    PYTHONPATH=src python tests/torch_sharded_ops.py RANK WORLD STORE OUT
"""

import json
import sys

import torch
import torch.distributed as dist


def _flash_cases():
    from torch.distributed.tensor import Replicate, Shard

    heads = [Shard(0), Shard(2)]
    # (name, (B, Sq, Skv, H, KVH, D), q placements, k/v placements,
    #  causal, window, softcap, per-row query offset)
    return [
        ("gqa_heads_sharded", (4, 16, 16, 8, 2, 16), heads, heads, True, 0,
         0.0, False),
        ("mqa_kv_whole", (4, 16, 16, 8, 1, 16), heads, [Shard(0),
                                                       Replicate()],
         True, 5, 30.0, False),
        ("gqa_kv_indivisible", (4, 16, 16, 6, 3, 8), heads,
         [Shard(0), Replicate()], True, 0, 0.0, False),
        ("seq_sharded_gathered", (4, 16, 16, 8, 4, 16),
         [Shard(1), Shard(2)], [Shard(1), Replicate()], True, 0, 0.0,
         False),
        ("decode_offsets", (4, 1, 16, 8, 2, 16), heads, heads, True, 0,
         0.0, True),
        ("cross_not_causal", (4, 12, 20, 8, 8, 16), heads, heads, False, 0,
         0.0, False),
    ]


def _err(got, want) -> float:
    return float((got.full_tensor() - want).abs().max())


def run(mesh) -> dict:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as sc_ops

    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, (b, sq, skv, h, kvh, d), qp, kvp, causal, window, cap, \
            per_row in _flash_cases():
        q = torch.randn(b, sq, h, d, generator=gen)
        k = torch.randn(b, skv, kvh, d, generator=gen)
        v = torch.randn(b, skv, kvh, d, generator=gen)
        w = torch.randn(b, sq, h, d, generator=gen)
        off = torch.tensor([3, 9, 14, 15], dtype=torch.int32) if per_row \
            else 0
        opts = dict(causal=causal, window=window, softcap=cap)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = fa_ops.flash_attention(*leaves, q_offset=off, **opts)
        want_g = torch.autograd.grad((want * w).sum(), leaves)
        dq, dk, dv = (distribute_tensor(t, mesh, p).requires_grad_(True)
                      for t, p in ((q, qp), (k, kvp), (v, kvp)))
        doff = distribute_tensor(off, mesh, [Shard(0), Replicate()]) \
            if per_row else 0
        got = fa_ops.flash_attention(dq, dk, dv, q_offset=doff, **opts)
        dw = distribute_tensor(w, mesh, list(got.placements))
        got_g = torch.autograd.grad((got * dw).sum(), (dq, dk, dv))
        out[f"flash/{name}"] = max([_err(got, want.detach())]
                                   + [_err(g, wg) for g, wg
                                      in zip(got_g, want_g)])
    for name, xp, ret in (("batch_channels", [Shard(0), Shard(2)], False),
                          ("batch_channels_state", [Shard(0), Shard(2)],
                           True),
                          ("length_gathered", [Shard(1), Shard(2)], True)):
        bsz, length, inner, n = 4, 24, 8, 4
        x = torch.randn(bsz, length, inner, generator=gen)
        dt = torch.rand(bsz, length, inner, generator=gen) * 0.5
        bm = torch.randn(bsz, length, n, generator=gen)
        cm = torch.randn(bsz, length, n, generator=gen)
        a = torch.randn(inner, n, generator=gen) * 0.5
        ds = torch.randn(inner, generator=gen)
        wy = torch.randn(bsz, length, inner, generator=gen)
        leaves = [t.clone().requires_grad_(True)
                  for t in (x, dt, bm, cm, a, ds)]
        want = sc_ops.mamba_scan(*leaves, ret)
        want_g = torch.autograd.grad(
            ((want[0] if ret else want) * wy).sum()
            + (want[1].sum() if ret else 0.0), leaves)
        bcp = [Shard(0), Replicate()] if xp[0] == Shard(0) \
            else [Shard(1), Replicate()]
        ap = [Replicate(), Shard(0)]
        args = [distribute_tensor(t, mesh, p).requires_grad_(True)
                for t, p in ((x, xp), (dt, xp), (bm, bcp), (cm, bcp),
                             (a, ap), (ds, ap))]
        got = sc_ops.mamba_scan(*args, ret)
        y = got[0] if ret else got
        dwy = distribute_tensor(wy, mesh, list(y.placements))
        got_g = torch.autograd.grad(
            (y * dwy).sum() + (got[1].sum() if ret else 0.0), args)
        pairs = list(zip(got, want)) if ret else [(got, want)]
        out[f"scan/{name}"] = max(
            [_err(g, wt.detach()) for g, wt in pairs]
            + [_err(g, wg) for g, wg in zip(got_g, want_g)])
    out["local_calls"] = {"flash": fa_ops.local_calls,
                          "scan": sc_ops.local_calls}
    return out


def main(rank: int, world: int, store_path: str, out_path: str) -> None:
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res = run(mesh)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
