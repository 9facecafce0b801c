"""Architecture registry: one module per assigned architecture (copies of
``repro/configs``; each imports only the port's ``ModelConfig``).

Each module defines:
  CONFIG        — the exact published configuration
  SMOKE         — a reduced same-family config for CPU tests
  SKIP_SHAPES   — {shape_name: reason} cells excluded from the dry-run
"""

from __future__ import annotations

import importlib
from typing import Dict, List

ARCH_IDS = [
    "llava_next_mistral_7b",
    "phi3_mini_3_8b",
    "gemma2_2b",
    "qwen2_0_5b",
    "olmo_1b",
    "rwkv6_7b",
    "seamless_m4t_medium",
    "olmoe_1b_7b",
    "deepseek_v2_236b",
    "zamba2_1_2b",
]


#: map from CLI-style ids (dashes) to module names
def _norm(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_module(arch: str):
    return importlib.import_module(f"{__name__}.{_norm(arch)}")


def get_config(arch: str):
    return get_module(arch).CONFIG


def get_smoke_config(arch: str):
    return get_module(arch).SMOKE


def skip_shapes(arch: str) -> Dict[str, str]:
    return getattr(get_module(arch), "SKIP_SHAPES", {})


def all_archs() -> List[str]:
    return list(ARCH_IDS)
