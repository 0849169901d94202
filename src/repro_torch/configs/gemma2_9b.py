"""Gemma-2 9B [arXiv:2408.00118]: 42L, d=3584, 16H (GQA kv=8, head 256),
GeGLU d_ff=14336, vocab 256000; alternating local(4096)/global attention,
attention softcap 50, final-logit softcap 30, pre+post RMSNorms, tied
embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    ffn_kind="geglu",
    local_window=4096,
    block_pattern=("attn_local", "attn_dense"),
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    tie_embeddings=True,
    loss_chunk=512,
)
