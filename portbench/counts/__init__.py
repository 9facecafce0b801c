"""Frozen counts of useful work: the peaks of the card (``peaks``), the work
and bound of one kernel call (``kernels``), and one module a model family
(named as the configuration's ``family``) with the FLOPs of a prefill."""
