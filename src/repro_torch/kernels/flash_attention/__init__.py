"""Blockwise GQA attention: the CUDA kernel (``flash_attention.py`` binds
``csrc/flash_attention.cu``), its plain PyTorch version (``ref.py``) and
the public op (``ops.py``)."""
