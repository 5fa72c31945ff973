"""Assigned-architecture configs (public-literature presets), as in the
reference's ``repro/configs``.

Each module exposes ``config()`` → ArchConfig (the exact assigned
dimensions) and ``smoke_config()`` → a reduced same-family config for CPU
smoke tests. ``repro_torch.configs.registry`` maps ``--arch <id>`` to
them; the port carries the dense family's (gemma2_2b, stablelm_3b,
qwen1_5_110b, nemotron_4_340b), the rest wait for their models.
"""

from .registry import ARCHS, SHAPES, get_config, get_smoke_config, shape_spec

__all__ = ["ARCHS", "SHAPES", "get_config", "get_smoke_config",
           "shape_spec"]
