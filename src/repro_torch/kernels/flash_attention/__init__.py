"""Flash attention: the hand-written CUDA kernel (``flash_attention.py``
and ``csrc/flash_attention.cu``), its plain torch versions (``ref.py``)
and the GQA dispatch between them (``ops.py``)."""
