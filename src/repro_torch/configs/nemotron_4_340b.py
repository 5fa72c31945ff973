"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728,
vocab=256000, squared-ReLU MLP [arXiv:2402.16819; unverified].

Largest assigned cell. fp32 Adam moments would need ~5.4 TB (> the 4 TB
single-pod HBM) → the multi-versioner's legality branch selects the 8-bit
optimizer-state variant (train/optimizer.py)."""

from repro_torch.models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="nemotron_4_340b", family="dense",
        layers=96, d_model=18432, n_heads=96, kv_heads=8,
        d_ff=73728, vocab=256000,
        mlp_act="sqrelu", tie_embeddings=False,
        # §Perf hillclimb winner: dots-remat (the port checkpoints as
        # "full": transformer.forward)
        microbatch=16, remat="dots", fused_xent=True, opt_8bit=True,
        seq_shard=True,
        skip_shapes={"long_500k": "full quadratic attention"},
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="nemotron_4_340b_smoke", family="dense",
        layers=2, d_model=96, n_heads=8, kv_heads=2, d_ff=192,
        vocab=512, mlp_act="sqrelu", tie_embeddings=False,
        microbatch=1, remat="none",
    )
