"""Architecture config registry of the port.

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` the reduced same-family config the CPU tests
use; ``get_arch_config(name, layers=n)`` the full-width config cut to n
layers.  Only the archs this slice serves are registered; the others follow
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
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
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


def get_arch_config(name: str, *, smoke: bool = False, layers: int = 0):
    """The launchers' ``--arch`` / ``--smoke`` / ``--layers``: the smoke
    config, the full-width config cut to ``layers`` (the archs whose
    module has a ``cut``: those too deep for one card's draw), or the
    published one."""
    if smoke and layers:
        raise ValueError("smoke and a layer cut are exclusive")
    if smoke:
        return get_smoke_config(name)
    if not layers:
        return get_config(name)
    cut = getattr(_module(name), "cut", None)
    if cut is None:
        with_cut = sorted(a for a in ARCHS if hasattr(_module(a), "cut"))
        raise ValueError(f"arch {name!r} has no depth cut; the archs with "
                         f"one: {with_cut}")
    return cut(layers)
