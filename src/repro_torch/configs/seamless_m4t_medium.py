"""seamless-m4t-medium [audio]: enc-dec multimodal backbone
[arXiv:2308.11596; hf]. 12L dec + 12L enc, d_model=1024, 16H (kv=16),
d_ff=4096, vocab=256206. The audio frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, S_src, d_model).

Vocab 256206 is indivisible by tp=16 → planner pads to a multiple of
tp×128 (legality branch, DESIGN.md §4)."""

from repro_torch.models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="seamless_m4t_medium", family="audio",
        layers=12, d_model=1024, n_heads=16, kv_heads=16,
        d_ff=4096, vocab=256206,
        is_encdec=True, enc_layers=12, embeds_input=False,
        mlp_act="gelu", tie_embeddings=True,
        microbatch=1, remat="full", fused_xent=True,
        skip_shapes={"long_500k": "full quadratic attention (enc-dec); "
                                  "sub-quadratic variants only"},
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="seamless_m4t_medium_smoke", family="audio",
        layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
        vocab=503,  # deliberately indivisible → exercises padding
        is_encdec=True, enc_layers=2, mlp_act="gelu",
        microbatch=1, remat="none",
    )
