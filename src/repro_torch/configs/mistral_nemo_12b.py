"""Mistral-NeMo-12B [hf:mistralai/Mistral-Nemo-Base-2407]: 40L, d=5120,
32H (GQA kv=8, head 128), SwiGLU d_ff=14336, vocab 131072, 128k context
(rope theta 1M).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1000000.0,
    block_pattern=("attn_dense",),
    loss_chunk=512,
)
