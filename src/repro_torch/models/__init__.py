"""The port's LM models (``common``, ``transformer``): the reference's
``repro/models`` in PyTorch, dense family first."""
