"""Chameleon-34B [arXiv:2405.09818]: early-fusion token-based mixed-modal,
48L, d=8192, 64H (GQA kv=8), d_ff=22016, vocab 65536 including VQ image
tokens (image tokenizer frontend stubbed).  Uses qk-norm for stability,
per the paper.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    block_pattern=("attn_dense",),
    loss_chunk=512,
)
