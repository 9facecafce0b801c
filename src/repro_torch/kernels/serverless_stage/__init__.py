"""Payload staging for the serverless chain hop: the CUDA chunk-gather
kernel (``stage.py`` binds ``csrc/serverless_stage.cu``), its plain PyTorch
version (``ref.py``), and the routing planners and public ops (``ops.py``)."""
