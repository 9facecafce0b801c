"""Plain float32 references, one a model family (``<family>.py``), each
with ``served_logits(config, params, prompt, fed, precision)``."""
