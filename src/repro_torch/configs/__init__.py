"""Architecture registry of the port: ``get(name)`` -> ModelConfig.

Counterpart of ``repro.configs``.  ``ARCHS`` and ``ALIASES`` name every
architecture of the reference; the port has the configurations of the
archs built of attention and recurrent blocks (``PORTED``).  ``get`` of
another one raises and says which part of ROADMAP.md brings it.

Each architecture declares which shape cells apply (:func:`shape_cells`):
an encoder has no decode cell, and only the recurrent families take
long_500k.
"""
from __future__ import annotations

import importlib
from typing import List, Tuple

from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell

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
PORTED = ("hubert_xlarge", "chameleon_34b", "recurrentgemma_2b",
          "stablelm_12b", "gemma2_9b", "mistral_nemo_12b", "qwen3_1_7b",
          "xlstm_125m")

ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES["qwen3-1.7b"] = "qwen3_1_7b"
ALIASES["llama4-scout-17b-a16e"] = "llama4_scout_17b_a16e"

_LATER = ("not ported yet: its blocks and config come with ROADMAP.md "
          "Queue 1 item 16b.4 (MLA and MoE: DeepSeek-V3, Llama 4 Scout)")


def get(name: str) -> ModelConfig:
    arch = ALIASES.get(name, name)
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}")
    if arch not in PORTED:
        raise NotImplementedError(f"{arch} is {_LATER}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def shape_cells(cfg: ModelConfig) -> List[ShapeCell]:
    """The applicable (arch x shape) cells for this architecture."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"]]
    if cfg.family != "encoder":
        cells.append(SHAPES["decode_32k"])
        if cfg.family in ("hybrid", "ssm", "xlstm"):
            cells.append(SHAPES["long_500k"])
    return cells


def all_cells() -> List[Tuple[str, str]]:
    """(arch, cell name) of every ported arch, in ``ARCHS`` order: the
    reference's ``all_cells`` restricted to ``PORTED``."""
    return [(a, cell.name) for a in ARCHS if a in PORTED
            for cell in shape_cells(get(a))]
