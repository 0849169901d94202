"""DeepSeek-V3 671B [arXiv:2412.19437]: 61L, d=7168, 128 MLA heads,
MoE 1 shared + 256 routed top-8 (d_ff_expert=2048), first 3 layers dense
(d_ff=18432), vocab 129280, MTP.

Counterpart of ``repro.configs.deepseek_v3_671b``, with its values.  The
reference shards the experts 256 ways (``ep_axes``); the port runs them
on one card (``moe_impl="gather"``), where the whole model (671.6e9
parameters, 1,343 GB in bf16) does not fit: a card runs it with its
layers cut.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    d_ff_dense=18432,
    vocab=129280,
    prefix_blocks=("mla_dense",) * 3,
    block_pattern=("attn_moe",),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048, num_shared=1,
                  d_ff_shared=2048, ep_axes=("data", "model"),
                  capacity_factor=1.25),
    mtp=True,
    rope_theta=10000.0,
    loss_chunk=512,
)
