"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) d_ff=1024/expert,
vocab=50304, MoE 64 experts top-8, every layer [arXiv:2409.02060; hf]."""

from repro_torch.models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="olmoe_1b_7b", family="moe",
        layers=16, d_model=2048, n_heads=16, kv_heads=16,
        d_ff=1024, vocab=50304,
        n_experts=64, experts_topk=8, expert_d_ff=1024,
        moe_every=1, moe_offset=0,
        mlp_act="silu", tie_embeddings=False,
        microbatch=2, remat="full", fused_xent=True,
        skip_shapes={"long_500k": "full quadratic attention"},
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="olmoe_1b_7b_smoke", family="moe",
        layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=32,
        vocab=512, n_experts=8, experts_topk=2, expert_d_ff=32,
        moe_every=1, tie_embeddings=False,
        microbatch=1, remat="none",
    )
