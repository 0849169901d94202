"""StableLM-2-12B [hf:stabilityai]: 40L, d=5120, 32H (GQA kv=8),
d_ff=13824 (SwiGLU), vocab 100352.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab=100352,
    block_pattern=("attn_dense",),
    loss_chunk=512,
)
