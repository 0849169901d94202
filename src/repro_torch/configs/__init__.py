"""Architecture registry of the port: ``get(name)`` -> ModelConfig.

Counterpart of ``repro.configs``.  ``ARCHS`` and ``ALIASES`` name every
architecture of the reference, and the port has the configuration of
each (``PORTED``, all of them).

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
PORTED = tuple(ARCHS)

ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES["qwen3-1.7b"] = "qwen3_1_7b"
ALIASES["llama4-scout-17b-a16e"] = "llama4_scout_17b_a16e"


def get(name: str) -> ModelConfig:
    arch = ALIASES.get(name, name)
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}")
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
    """(arch, cell name) of every arch, in ``ARCHS`` order, as the
    reference's ``all_cells``."""
    return [(a, cell.name) for a in ARCHS for cell in shape_cells(get(a))]
