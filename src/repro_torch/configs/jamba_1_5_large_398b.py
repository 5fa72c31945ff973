"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, vocab=65536, MoE 16e top-2, Mamba:attn 7:1 interleave
[arXiv:2403.19887; hf].

Period-8 superblock: attention at index 4, Mamba elsewhere; MoE FFN on odd
indices. Runs long_500k (hybrid → sub-quadratic: Mamba state + 9 attention
layers with KV cache)."""

from repro_torch.models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba_1_5_large_398b", family="hybrid",
        layers=72, d_model=8192, n_heads=64, kv_heads=8,
        d_ff=24576, vocab=65536,
        period=8, attn_idx=4,
        n_experts=16, experts_topk=2, expert_d_ff=24576,
        moe_every=2, moe_offset=1,
        ssm_state=16, ssm_expand=2,
        mlp_act="silu", tie_embeddings=False,
        microbatch=16, remat="full", fused_xent=True, opt_8bit=True,
        seq_shard=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="jamba_1_5_large_398b_smoke", family="hybrid",
        layers=8, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=512, period=4, attn_idx=2,
        n_experts=4, experts_topk=2, expert_d_ff=64,
        moe_every=2, moe_offset=1, ssm_state=4, ssm_expand=2,
        tie_embeddings=False,
        microbatch=1, remat="none",
    )
