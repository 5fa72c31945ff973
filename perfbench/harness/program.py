"""What the benchmark takes from the program (``repro_torch``): its
configuration type, and the kernels' launch counters and plain-call
counters, printed on an earlier line of every run."""

from __future__ import annotations

import dataclasses
from typing import Dict

#: the configuration file's ``model`` keys that are the benchmark's
#: own (the layout of the weights), not the program's ``ArchConfig``
LAYOUT_ONLY = ("padded_vocab",)


def arch_config(model: Dict):
    """The port's ``ArchConfig`` of a configuration file's ``model``;
    raises where the program would lay the weights out otherwise than
    ``harness/weights.py`` does."""
    import torch

    from repro_torch.models.common import ArchConfig
    from repro_torch.models.transformer import TP_DEFAULT

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kwargs = {k: v for k, v in model.items() if k not in LAYOUT_ONLY}
    unknown = set(kwargs) - fields
    if unknown:
        raise ValueError(f"model keys the port does not know: "
                         f"{sorted(unknown)}")
    kwargs["dtype"] = getattr(torch, kwargs.get("dtype", "bfloat16"))
    kwargs.setdefault("name", "bench")
    cfg = ArchConfig(**kwargs)
    if cfg.padded_vocab(TP_DEFAULT) != model["padded_vocab"]:
        raise ValueError(f"the port pads the vocabulary to "
                         f"{cfg.padded_vocab(TP_DEFAULT)}, the file says "
                         f"{model['padded_vocab']}")
    if cfg.n_experts:
        from repro_torch.models.moe import padded_experts
        if padded_experts(cfg) != cfg.n_experts:
            raise ValueError("experts padded by the port: the weights' "
                             "layout would differ")
    return cfg


def dropless(cfg, tokens) -> bool:
    """Whether the port's capacity holds every assignment of a batch of
    ``tokens`` tokens (an expert takes at most one a token)."""
    from repro_torch.models.moe import capacity
    return capacity(cfg, tokens, cfg.n_experts) >= tokens


def counters() -> Dict[str, int]:
    """The kernels' launches and the calls that took a plain version
    (which should stay 0 on the card)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as sc_ops
    return {"flash_launches": fa.launches,
            "flash_bwd_launches": fa.bwd_launches,
            "flash_plain_calls": fa_ops.plain_calls,
            "scan_plain_calls": sc_ops.plain_calls + sc_ops.bwd_plain_calls}
