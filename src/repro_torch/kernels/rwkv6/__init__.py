"""The RWKV-6 WKV scan: the CUDA kernel (``rwkv6.py`` binds
``csrc/wkv.cu``), its plain PyTorch versions (``ref.py``) and the public
ops (``ops.py``)."""
