"""Architecture configs: the 10 assigned archs, as plain data.

``get_config(name)`` returns the full :class:`ModelConfig` at its published
widths; ``get_smoke_config(name)`` returns the reduced same-family config
used by the CPU tests.  ``ARCHS`` lists every selectable ``--arch`` id.
"""

from __future__ import annotations

import importlib

ARCHS = (
    "phi3-mini-3.8b",
    "gemma-2b",
    "stablelm-3b",
    "qwen1.5-32b",
    "internvl2-26b",
    "granite-moe-1b-a400m",
    "granite-moe-3b-a800m",
    "rwkv6-3b",
    "whisper-medium",
    "recurrentgemma-2b",
)

_MODULES = {
    "phi3-mini-3.8b": "phi3_mini",
    "gemma-2b": "gemma_2b",
    "stablelm-3b": "stablelm_3b",
    "qwen1.5-32b": "qwen15_32b",
    "internvl2-26b": "internvl2_26b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "rwkv6-3b": "rwkv6_3b",
    "whisper-medium": "whisper_medium",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.config()


def get_smoke_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.smoke_config()
