"""Model configuration for the port's LM stack.

Counterpart of ``repro.models.config``: a ``ModelConfig`` describes one
architecture, whose layer stack cycles ``block_pattern`` (``cycles``
times, then ``remainder_blocks``) after optional ``prefix_blocks``.  The
fields keep the reference's names and defaults, so that ``cfg.replace``
takes the same keywords; ``dtype()`` returns torch dtypes.

``ShardingRules``, ``MoEConfig``, ``MLAConfig`` and ``RGLRUConfig`` are
the reference's.  ``moe_impl`` picks the MoE's path as the reference's
does: ``"gather"`` (the default) or ``"a2a"``, the expert-parallel
exchange over ``MoEConfig.ep_axes`` of the ambient ``RankMesh``
(``repro_torch.models.meshctx``).  Of ``ShardingRules`` only ``batch``
is read (the token blocks of ``a2a``): the port has no GSPMD, so the rest
of the model runs replicated on every rank.  Not carried over:
``scan_layers`` (the stack is a ``ModuleList``).  ``attn_impl``,
``attn_block`` and ``MoEConfig``'s ``router_dtype`` are kept so that
``replace`` takes the reference's keywords, and nothing reads them: every
cache-less attention runs the flash kernel whatever they say
(``repro_torch.models.blocks.attend``), and the router runs in float32,
as the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
REMATS = ("none", "full", "dots")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0            # shared (always-on) experts
    d_ff_shared: int = 0
    ep_axes: Tuple[str, ...] = ("model",)      # the a2a exchange's axes
    capacity_factor: float = 1.25
    router_dtype: str = "float32"              # inert


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block."""
    d_rnn: int = 2560
    conv_width: int = 4
    block_width: int = 2560        # lru gate width


@dataclass(frozen=True)
class ShardingRules:
    """Logical tensor axes -> mesh axis names (None = replicated), the
    reference's fields and defaults.  The port reads ``batch`` alone (the
    a2a path's token blocks); the others name a GSPMD layout the port does
    not build."""
    batch: Tuple[str, ...] = ("pod", "data")
    seq: Optional[str] = None
    heads: Optional[str] = "model"
    kv_heads: Optional[str] = "model"
    d_model: Optional[str] = None
    d_ff: Optional[str] = "model"
    vocab: Optional[str] = "model"
    expert: Tuple[str, ...] = ("model",)
    kv_seq: Optional[str] = None


MOE_IMPLS = ("gather", "a2a")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | hybrid | xlstm | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    d_ff_dense: int = 0            # dense-FFN width for mixed MoE stacks
    block_pattern: Tuple[str, ...] = ("attn_dense",)
    prefix_blocks: Tuple[str, ...] = ()     # unrolled layers before the body
    causal: bool = True
    tie_embeddings: bool = False
    # attention options
    qk_norm: bool = False                   # qwen3
    ffn_kind: str = "swiglu"                # swiglu | geglu | gelu
    attn_softcap: float = 0.0               # gemma2
    logit_softcap: float = 0.0              # gemma2
    local_window: int = 4096                # for "attn_local" blocks
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None     # recurrentgemma's rec blocks
    mtp: bool = False                       # DeepSeek multi-token prediction
    embed_inputs: bool = True
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"              # read nowhere, as in the
    #                                         reference: AdamWConfig decides
    remat: str = "full"                     # full | dots | none
    moe_impl: str = "gather"                # gather | a2a (see above)
    attn_impl: str = "dense"                # inert (see above)
    attn_block: int = 1024                  # inert
    loss_chunk: int = 0                     # 0 = unchunked cross-entropy
    norm_eps: float = 1e-6
    post_norms: bool = False                # gemma2 pre+post norms
    sharding: ShardingRules = dataclasses.field(
        default_factory=ShardingRules)

    def __post_init__(self):
        for which in ("param", "compute", "opt"):
            if getattr(self, which + "_dtype") not in DTYPES:
                raise ValueError(f"{which}_dtype must be one of "
                                 f"{tuple(DTYPES)}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got "
                             f"{self.remat!r}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got "
                             f"{self.moe_impl!r}")

    # ---- derived -------------------------------------------------------
    @property
    def cycles(self) -> int:
        body = self.n_layers - len(self.prefix_blocks)
        return body // len(self.block_pattern)

    @property
    def remainder_blocks(self) -> Tuple[str, ...]:
        body = self.n_layers - len(self.prefix_blocks)
        rem = body % len(self.block_pattern)
        return tuple(self.block_pattern[:rem])

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Every layer's block kind, in order: prefix, body, remainder."""
        return (tuple(self.prefix_blocks)
                + tuple(self.block_pattern) * self.cycles
                + self.remainder_blocks)

    def dtype(self, which: str) -> torch.dtype:
        return DTYPES[getattr(self, which + "_dtype")]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests (the reference's sizes)."""
    kw = dict(
        n_layers=max(len(cfg.block_pattern) + len(cfg.prefix_blocks), 2),
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        d_ff=128, vocab=256, head_dim=16, local_window=32,
        d_ff_dense=128 if cfg.d_ff_dense else 0, remat="none")
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64, d_ff_shared=64 if cfg.moe.num_shared else 0,
            ep_axes=("model",))
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.rglru is not None:
        kw["rglru"] = RGLRUConfig(d_rnn=64, conv_width=4, block_width=64)
    return cfg.replace(**kw)
