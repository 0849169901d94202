"""RecurrentGemma-2B / Griffin [arXiv:2402.19427]: 26L, d=2560, pattern
(rec, rec, local-attn) 1:2, 10 heads MQA (kv=1, head_dim 256), GeGLU
d_ff=7680, RG-LRU width 2560, local window 2048, vocab 256000.

Sub-quadratic: runs the long_500k cell.  Counterpart of
``repro.configs.recurrentgemma_2b``, with its values.
"""
from repro_torch.models.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    ffn_kind="geglu",
    local_window=2048,
    block_pattern=("rec", "rec", "attn_local"),
    rglru=RGLRUConfig(d_rnn=2560, conv_width=4, block_width=2560),
    tie_embeddings=True,
    loss_chunk=512,
)
