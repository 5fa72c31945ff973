"""Checkpoints of the port (``ckpt``): the reference's
``repro/checkpoint`` layout, written from and restored onto torch
tensors."""
