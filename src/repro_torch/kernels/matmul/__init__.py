"""Blocked matmul: the hand-written CUDA kernel (``matmul.py`` and
``csrc/matmul.cu``), its plain torch version (``ref.py``) and the
dispatch between them (``ops.py``)."""
