"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family]: 28L, d=2048, 16H (GQA kv=8,
head 128), SwiGLU d_ff=6144, vocab 151936, qk-norm, tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    block_pattern=("attn_dense",),
    loss_chunk=512,
)
