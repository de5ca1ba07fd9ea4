"""Assigned architecture configs (``--arch <id>``).  Exact published
numbers; sources per the assignment sheet."""
from __future__ import annotations

import importlib

ARCHS = [
    "llama4_scout_17b_a16e",
    "deepseek_v3_671b",
    "qwen1_5_110b",
    "command_r_35b",
    "stablelm_1_6b",
    "qwen2_7b",
    "pixtral_12b",
    "jamba_1_5_large_398b",
    "mamba2_130m",
    "seamless_m4t_large_v2",
]

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str):
    key = name.replace(".", "_").replace("-", "_")
    key = {"qwen1_5_110b": "qwen1_5_110b"}.get(key, key)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCHS}
