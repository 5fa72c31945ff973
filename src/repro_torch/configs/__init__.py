"""Assigned-architecture configs (public-literature presets), as in the
reference's ``repro/configs``.

Each module exposes ``config()`` → ArchConfig (the exact assigned
dimensions) and ``smoke_config()`` → a reduced same-family config for CPU
smoke tests. ``repro_torch.configs.registry`` maps ``--arch <id>`` to
them; the port carries every family's: dense (gemma2_2b, stablelm_3b,
qwen1_5_110b, nemotron_4_340b), MoE (olmoe_1b_7b, qwen2_moe_a2_7b),
hybrid (jamba_1_5_large_398b), ssm (xlstm_125m), audio
(seamless_m4t_medium, encoder-decoder) and vlm (llava_next_mistral_7b,
inputs as embeddings).
"""

from .registry import ARCHS, SHAPES, get_config, get_smoke_config, shape_spec

__all__ = ["ARCHS", "SHAPES", "get_config", "get_smoke_config",
           "shape_spec"]
