"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — alternating
mLSTM (matrix-memory) and sLSTM (scalar-memory) blocks, no separate FFN
[arXiv:2405.04517; unverified].

Runs long_500k: recurrent state decode is O(1) per token. Tiny model: the
planner's profitability tree keeps it pure-DP (model axis unused) — the
paper's "not worth distributing" branch."""

from repro_torch.models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm_125m", family="ssm",
        layers=12, d_model=768, n_heads=4, kv_heads=4,
        d_ff=0, vocab=50304,
        xlstm_pattern=("mlstm", "slstm"),
        tie_embeddings=True,
        microbatch=1, remat="full", fused_xent=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm_125m_smoke", family="ssm",
        layers=2, d_model=64, n_heads=2, kv_heads=2, d_ff=0,
        vocab=512, xlstm_pattern=("mlstm", "slstm"),
        microbatch=1, remat="none",
    )
