"""Llama-4 Scout 17B-active 16E [hf:meta-llama/Llama-4-Scout-17B-16E]:
48L, d=5120, 40H (GQA kv=8), MoE 16 experts top-1 + shared expert
(d_ff=8192), vocab 202048, early fusion (vision frontend stubbed —
image patches arrive as tokens in the shared vocab).

Counterpart of ``repro.configs.llama4_scout_17b_a16e``, with its values.
The whole model (107.8e9 parameters, 216 GB in bf16) does not fit one
card: a card runs it with its layers cut.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    block_pattern=("attn_moe",),
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192, num_shared=1,
                  d_ff_shared=8192, ep_axes=("model",),
                  capacity_factor=1.25),
    rope_theta=500000.0,
    loss_chunk=512,
)
