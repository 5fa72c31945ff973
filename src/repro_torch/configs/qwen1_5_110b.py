"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152,
vocab=152064, QKV bias [hf:Qwen/Qwen1.5-0.5B family; hf]."""

from repro_torch.models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1_5_110b", family="dense",
        layers=80, d_model=8192, n_heads=64, kv_heads=8,
        d_ff=49152, vocab=152064,
        qkv_bias=True, mlp_act="silu", tie_embeddings=False,
        microbatch=16, remat="full", fused_xent=True, opt_8bit=True,
        seq_shard=True,
        skip_shapes={"long_500k": "full quadratic attention"},
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen1_5_110b_smoke", family="dense",
        layers=2, d_model=64, n_heads=8, kv_heads=2, d_ff=128,
        vocab=512, qkv_bias=True, tie_embeddings=False,
        microbatch=1, remat="none",
    )
