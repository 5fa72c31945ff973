"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216,
vocab=256000 — alternating local(4096)/global attention, attn softcap 50,
final-logit softcap 30 [arXiv:2408.00118; hf].

8 q-heads < tp=16 → head-axis TP fails the divisibility legality check;
the planner falls back to mlp/row-parallel sharding for this arch
(DESIGN.md §4). long_500k skipped: global layers are quadratic."""

from repro_torch.models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2_2b", family="dense",
        layers=26, d_model=2304, n_heads=8, kv_heads=4,
        d_ff=9216, vocab=256000,
        alt_local_global=True, sliding_window=4096,
        attn_softcap=50.0, logit_softcap=30.0,
        mlp_act="gelu", tie_embeddings=True,
        microbatch=2, remat="full", fused_xent=True,
        seq_shard=True,
        skip_shapes={"long_500k": "global-attention layers are quadratic"},
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="gemma2_2b_smoke", family="dense",
        layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=512, alt_local_global=True, sliding_window=32,
        attn_softcap=50.0, logit_softcap=30.0, mlp_act="gelu",
        microbatch=1, remat="none",
    )
