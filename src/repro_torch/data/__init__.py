"""Synthetic LM data, document packing and the device feed (the counterpart
of ``repro.data``)."""

from .pipeline import (SyntheticLM, make_batch_iterator, pack_documents,
                       to_device)

__all__ = ["SyntheticLM", "pack_documents", "to_device",
           "make_batch_iterator"]
