"""Selective scan (Mamba): the hand-written CUDA kernel
(``mamba_scan.py`` and ``csrc/mamba_scan.cu``), its plain torch version
(``ref.py``) and the dispatch between them (``ops.py``)."""
