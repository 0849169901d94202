"""Architecture registry of the port: ``get(name)`` -> ModelConfig.

Counterpart of ``repro.configs``.  ``ARCHS`` and ``ALIASES`` name every
architecture of the reference; the port has the configurations of the
dense archs whose blocks it runs.  ``get`` of another one raises and says
which part of ROADMAP.md brings it.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "deepseek_v3_671b",
    "llama4_scout_17b_a16e",
    "hubert_xlarge",
    "chameleon_34b",
    "recurrentgemma_2b",
    "stablelm_12b",
    "gemma2_9b",
    "mistral_nemo_12b",
    "qwen3_1_7b",
    "xlstm_125m",
]
PORTED = ("gemma2_9b", "qwen3_1_7b")

ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES["qwen3-1.7b"] = "qwen3_1_7b"
ALIASES["llama4-scout-17b-a16e"] = "llama4_scout_17b_a16e"

_LATER = ("not ported yet: its blocks and config come with ROADMAP.md "
          "Queue 1 item 16b (the remaining block kinds and their archs)")


def get(name: str) -> ModelConfig:
    arch = ALIASES.get(name, name)
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}")
    if arch not in PORTED:
        raise NotImplementedError(f"{arch} is {_LATER}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
