"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) d_ff=1408/expert,
vocab=151936, 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

60 % 16 ≠ 0 → routed experts padded 60 → 64 with router logits masked
(legality branch, DESIGN.md §4)."""

from repro_torch.models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2_moe_a2_7b", family="moe",
        layers=24, d_model=2048, n_heads=16, kv_heads=16,
        d_ff=1408, vocab=151936,
        n_experts=60, experts_topk=4, n_shared_experts=4,
        expert_d_ff=1408, moe_every=1, moe_offset=0,
        qkv_bias=True, mlp_act="silu", tie_embeddings=False,
        microbatch=2, remat="full", fused_xent=True,
        skip_shapes={"long_500k": "full quadratic attention"},
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2_moe_a2_7b_smoke", family="moe",
        layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=32,
        vocab=512, n_experts=6, experts_topk=2, n_shared_experts=1,
        expert_d_ff=32, qkv_bias=True, tie_embeddings=False,
        microbatch=1, remat="none",
    )
