"""llava-next-mistral-7b [vlm]: Mistral-7B backbone — 32L d_model=4096
32H (GQA kv=8) d_ff=14336 vocab=32000, sliding-window 4096
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

The anyres vision frontend is a STUB: input_specs() provides pre-projected
patch+text embeddings (B, S, d_model); the backbone transformer is what is
built/sharded/lowered here."""

from repro_torch.models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llava_next_mistral_7b", family="vlm",
        layers=32, d_model=4096, n_heads=32, kv_heads=8,
        d_ff=14336, vocab=32000,
        sliding_window=4096, embeds_input=True,
        mlp_act="silu", tie_embeddings=False,
        microbatch=4, remat="full", fused_xent=True,
        skip_shapes={"long_500k": "assigned long-context shapes run on "
                                  "ssm/hybrid archs only"},
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llava_next_mistral_7b_smoke", family="vlm",
        layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=512, sliding_window=32, embeds_input=True,
        tie_embeddings=False,
        microbatch=1, remat="none",
    )
