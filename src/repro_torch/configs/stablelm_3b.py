"""stablelm-3b [dense]: 32L d_model=2560 32H (kv=32, MHA) d_ff=6912,
vocab=50304 [hf:stabilityai/stablelm family; unverified]."""

from repro_torch.models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm_3b", family="dense",
        layers=32, d_model=2560, n_heads=32, kv_heads=32,
        d_ff=6912, vocab=50304,
        mlp_act="silu", tie_embeddings=False,
        microbatch=2, remat="full", fused_xent=True,
        skip_shapes={"long_500k": "full quadratic attention"},
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="stablelm_3b_smoke", family="dense",
        layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
        vocab=512, tie_embeddings=False,
        microbatch=1, remat="none",
    )
