"""Batched RACE-hash lookup: the CUDA kernels (``race_lookup.py`` binds
``csrc/race_lookup.cu``), their plain PyTorch versions (``ref.py``) and the
public ops (``ops.py``)."""
