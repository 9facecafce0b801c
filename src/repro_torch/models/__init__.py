"""PyTorch model zoo (the counterpart of ``repro.models``): every family
of the ten published configs (dense, moe with MLA, ssm (rwkv6), the
Mamba-2 hybrid and the encoder-decoder), with the flash-attention and WKV
kernels on the card."""

from .config import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                     SHAPES_BY_NAME, TRAIN_4K, ModelConfig, ShapeSpec)
from .model import (decode_step, forward_full, init_decode_cache,
                    loss_from_hidden, prefill, train_loss)
from .params import (count_params, count_params_config, init_params,
                     params_from_numpy, trainable)

__all__ = [
    "ModelConfig", "ShapeSpec", "ALL_SHAPES", "SHAPES_BY_NAME", "TRAIN_4K",
    "PREFILL_32K", "DECODE_32K", "LONG_500K", "decode_step", "forward_full",
    "init_decode_cache", "loss_from_hidden", "prefill", "train_loss",
    "count_params", "count_params_config", "init_params",
    "params_from_numpy", "trainable",
]
