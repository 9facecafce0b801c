"""PyTorch model zoo (the counterpart of ``repro.models``): the dense and
ssm (rwkv6) families, with the flash-attention and WKV kernels on the
card. The moe, hybrid and encdec families wait (ROADMAP Queue 1 item 6)."""

from .config import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                     SHAPES_BY_NAME, TRAIN_4K, ModelConfig, ShapeSpec)
from .model import (decode_step, forward_full, init_decode_cache,
                    loss_from_hidden, prefill, train_loss)
from .params import (count_params, count_params_config, init_params,
                     params_from_numpy)

__all__ = [
    "ModelConfig", "ShapeSpec", "ALL_SHAPES", "SHAPES_BY_NAME", "TRAIN_4K",
    "PREFILL_32K", "DECODE_32K", "LONG_500K", "decode_step", "forward_full",
    "init_decode_cache", "loss_from_hidden", "prefill", "train_loss",
    "count_params", "count_params_config", "init_params",
    "params_from_numpy",
]
