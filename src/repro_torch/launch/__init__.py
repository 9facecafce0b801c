"""Serving entry points of the port: the prefill/decode step factories
(``steps.py``) and batched greedy serving (``serve.py``)."""
