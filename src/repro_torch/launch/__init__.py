"""Entry points of the port: the train / prefill / decode step factories
and the input specs (``steps.py``), the meshes (``mesh.py``), the training
loop (``train.py``) and batched greedy serving (``serve.py``)."""
