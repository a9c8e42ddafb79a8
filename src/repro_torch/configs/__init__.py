"""Architecture config registry of the port.

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` the reduced same-family config the CPU tests
use.  Only the archs this slice serves are registered; the others follow
the ROADMAP's "Remaining families" item.
"""
from __future__ import annotations

import importlib

ARCHS = {
    "exanode-100m": "exanode_100m",
    "llama3.2-3b": "llama3_2_3b",
    "xlstm-125m": "xlstm_125m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen3-4b": "qwen3_4b",
    "gemma-2b": "gemma_2b",
    "granite-20b": "granite_20b",
}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke()
