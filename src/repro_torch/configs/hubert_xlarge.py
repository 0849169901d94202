"""HuBERT X-Large [arXiv:2106.07447]: encoder-only, 48L, d=1280, 16H,
d_ff=5120 (GELU MLP), vocab 504 (k-means target clusters).

The conv waveform frontend is a stub: the model takes precomputed frame
embeddings [B, T, d_model] (the trainer draws them from a fixed table,
``repro_torch.launch.train.frontend_stub``); training is masked-frame
prediction.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    causal=False,
    embed_inputs=False,           # frontend stub supplies embeddings
    ffn_kind="gelu",
    block_pattern=("attn_dense",),
)
