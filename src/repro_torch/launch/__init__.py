"""Entry points of the port: the train / prefill / decode step factories
(``steps.py``), the training loop (``train.py``) and batched greedy
serving (``serve.py``)."""
