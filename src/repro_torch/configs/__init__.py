"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

Port of ``repro/configs``. Each ``<arch>.py`` holds FULL (the published
config, the reference's numbers verbatim) and SMOKE (same family,
reduced) ModelConfigs, for all ten architectures, in the reference's
order.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "phi4_mini_3_8b",
    "mistral_large_123b",
    "deepseek_coder_33b",
    "h2o_danube_3_4b",
    "whisper_large_v3",
    "hymba_1_5b",
    "deepseek_v2_lite_16b",
    "llama4_scout_17b_a16e",
    "llama_3_2_vision_90b",
    "mamba2_1_3b",
]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"{__name__}.{name}")


def get_config(name: str):
    """The FULL (published) config of ``name`` (an id or its alias)."""
    return _module(name).FULL


def get_smoke_config(name: str):
    """The SMOKE (reduced) config of ``name``."""
    return _module(name).SMOKE
