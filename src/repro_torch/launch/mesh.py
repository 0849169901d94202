"""The card's constants, read by the roofline and the chip smoke test.

Counterpart of the constants of ``repro.launch.mesh`` for one NVIDIA H100
SXM, from NVIDIA's data sheet (dense rates, no sparsity, at the full
700 W power limit; a card set below it runs slower under load).  The
reference's mesh makers (``make_production_mesh`` and the rest) build a
TPU mesh of many chips; their counterpart, one process per card, waits
for the rank-per-card exchange (ROADMAP.md Queue 1, item 21).
"""
from __future__ import annotations

# bf16 (and fp16) on the tensor cores, dense: the rate charged for matrix
# products and attention
PEAK_FLOPS = 989e12
# float32 outside the tensor cores: the rate charged for the engine
# kernels' adds and key compares
PEAK_F32_FLOPS = 67e12
# HBM3, bytes a second
HBM_BW = 3.35e12
# NVLink 4, bytes a second each way between two cards: read only by the
# roofline's collective term, which is 0 on one card
LINK_BW = 450e9
