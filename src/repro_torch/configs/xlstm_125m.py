"""xLSTM-125M [arXiv:2405.04517]: 12L, d=768, 4 heads, alternating
mLSTM (matrix memory) / sLSTM (scalar memory) blocks, vocab 50304.
d_ff=0: blocks carry their own projections (mLSTM projection factor 2;
sLSTM post-GLU factor 4/3).

Linear-time: runs the long_500k cell.  Counterpart of
``repro.configs.xlstm_125m``, with its values.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
)
