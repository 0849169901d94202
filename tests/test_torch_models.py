"""The port's LM serving slice against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through ``repro`` (the
reference) and ``repro_torch``; the port's weights are the reference's,
carried across by ``params_from_numpy``.  On CPU tensors the port's flash
wrapper takes its plain version, so these tests pin the arithmetic around
the kernel; the kernel itself is held against the same plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The reference's Pallas flash kernel cannot run under the installed JAX
(``repro/kernels/flash_attention.py`` calls ``pl.load``, which JAX 0.9.0
lacks), so the attention oracle is ``repro.kernels.ref.mha_ref``.
"""
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.kernels.ref import mha_ref
from repro.launch.steps import make_prefill_step as j_prefill_step
from repro.launch.steps import make_serve_step as j_serve_step
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models.config import smoke_config as j_smoke

import repro_torch.configs as TC
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.models.config import smoke_config as t_smoke
from repro_torch.models.transfer import params_from_numpy

ARCHS = ("gemma2_9b", "qwen3_1_7b")
CPU = "cpu"
# float32: the reference's own decode-vs-prefill bound (tests/test_models.py)
F32_REL = 2e-4
# bf16, on body matrices at 1/sqrt(input width) (``_width_scaled``): XLA
# and PyTorch round to 8 bits at different places (the score and
# probability casts, each matmul's output, GELU).  About 4 such roundings
# a layer at 2^-8 each leave gaps near 1e-2 of the largest logit (over
# the prefill and 48 decode steps: mean 7.8e-3, largest 1.54e-2 for gemma2
# and 1.17e-2 for qwen3); the bound allows twice the largest.  The
# reference's own draw (body matrices at 1/sqrt(cycles), here 1) saturates
# the attention softcap and makes the random network chaotic, so that
# draw is held in float32 only.
BF16_REL = 3e-2


def _cfgs(arch, dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (j_smoke(JC.get(arch)).replace(**kw),
            t_smoke(TC.get(arch)).replace(**kw))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1.0, np.abs(a).max()))


def _width_scaled(jcfg, jp):
    """The reference's params with every body matrix at 1/sqrt(its input
    width), as ``chip_smoke.parity_model`` draws them: the reference's draw
    reads the stacked cycles axis as fan-in."""
    def rescale(path, a):
        if a.ndim < 3:                  # norms and scales: zeros
            return a
        width = a.shape[1] * a.shape[2] if path[-1].key == "wo" \
            else a.shape[1]
        return (a.astype(jnp.float32) * np.sqrt(jcfg.cycles / width)).astype(
            a.dtype)
    return {**jp, "body": jax.tree_util.tree_map_with_path(rescale,
                                                           jp["body"])}


@pytest.fixture(scope="module")
def models():
    """Reference params and the port's copy, per (arch, dtype, draw):
    the reference's own draw, or with body matrices at 1/sqrt(width)."""
    cache = {}

    def get(arch, dtype="float32", width_scaled=False):
        key = arch, dtype, width_scaled
        if key not in cache:
            jcfg, tcfg = _cfgs(arch, dtype)
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(3))
            if width_scaled:
                jp = _width_scaled(jcfg, jp)
            tree = jax.tree.map(np.asarray, jp)
            cache[key] = (jcfg, tcfg, jp, tree,
                          params_from_numpy(tcfg, tree, device=CPU))
        return cache[key]
    return get


# -- (a) the flash kernel's plain version against the reference oracle -----

@pytest.mark.parametrize("b,h,kh,s,hd", [
    (1, 2, 2, 128, 32), (2, 4, 2, 256, 32), (1, 8, 1, 128, 64),
    # HuBERT X-Large's and StableLM 12B's head dims
    (1, 4, 4, 100, 80), (1, 4, 1, 100, 160)])
@pytest.mark.parametrize("opts", [
    dict(causal=True), dict(causal=False),
    dict(causal=True, window=64), dict(causal=True, softcap=50.0)])
def test_flash_ref_matches_mha_ref(b, h, kh, s, hd, opts):
    """The grid of the reference's TestFlashAttention, within its 2e-5,
    and hd 80 and 160 at an S that is no multiple of 64."""
    rng = np.random.default_rng(b * 100 + h)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32) for shape in
               ((b, h, s, hd), (b, kh, s, hd), (b, kh, s, hd)))
    want = np.asarray(mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **opts))
    got = flash_attention_ref(_t(q), _t(k), _t(v), **opts)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(flash_attention(_t(q), _t(k), _t(v), **opts), got)


def test_flash_ref_bf16():
    """bf16 in and out, within the reference test's 5e-2."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(0, 1, (1, 2, 128, 32)).astype(np.float32)
               for _ in range(3))
    want = mha_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = flash_attention_ref(*(_t(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2)


# -- (b) attend, [B, S, H, hd], against both reference lowerings -----------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 24])
def test_attend_matches_reference(arch, window):
    jcfg, tcfg = _cfgs(arch)
    jcfg = jcfg.replace(attn_block=16)
    rng = np.random.default_rng(11)
    b, s, h, kh, hd = 2, 64, jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    q = rng.normal(0, 2, (b, s, h, hd)).astype(np.float32)
    k = rng.normal(0, 2, (b, s, kh, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kh, hd)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    got = tblocks.attend(tcfg, _t(q), _t(k), _t(v), window).numpy()
    for fn in (jblocks._attend, jblocks._attend_blockwise):
        want = fn(jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                  pos, window)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


# -- (c) numerics ------------------------------------------------------------

def test_common_numerics_match_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (2, 7, 4, 16)).astype(np.float32)
    scale = rng.normal(0, 1, (16,)).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(_t(x), _t(scale), 1e-6).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    for cap in (0.0, 50.0):
        np.testing.assert_allclose(
            tcommon.softcap(_t(x * 40), cap).numpy(),
            np.asarray(jcommon.softcap(jnp.asarray(x * 40), cap)),
            rtol=1e-6, atol=1e-5)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (10000.0, 1e6):
        js, jc = jcommon.rope_table(jnp.asarray(pos), 16, theta)
        ts, tc = tcommon.rope_table(torch.from_numpy(pos), 16, theta)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
        np.testing.assert_allclose(
            tcommon.apply_rope(_t(x), ts, tc).numpy(),
            np.asarray(jcommon.apply_rope(jnp.asarray(x), js, jc)),
            atol=1e-5)
    h = rng.normal(0, 2, (3, 5, 32)).astype(np.float32)
    for kind in ("swiglu", "geglu"):
        np.testing.assert_allclose(
            tcommon.swiglu(_t(h), kind).numpy(),
            np.asarray(jcommon.swiglu(jnp.asarray(h), kind)),
            rtol=1e-6, atol=1e-6)


# -- (d) the blocks, with and without a cache ---------------------------------

def _block(models, arch, i):
    """Layer i of the pattern: the reference's cycle-0 params, the port's
    layer module, and the window."""
    jcfg, tcfg, jp, _, tp = models(arch)
    kind = jcfg.block_pattern[i]
    jblk = jax.tree.map(lambda a: a[0], jp["body"][f"b{i}_{kind}"])
    window = jcfg.local_window if kind == "attn_local" else 0
    return jcfg, tcfg, jblk, tp.layers[i], window


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_reference(models, arch):
    rng = np.random.default_rng(2)
    jcfg = models(arch)[0]
    for i in range(len(jcfg.block_pattern)):
        jcfg, tcfg, jblk, layer, window = _block(models, arch, i)
        x = rng.normal(0, 1, (2, 40, jcfg.d_model)).astype(np.float32)
        pos = jnp.broadcast_to(jnp.arange(40, dtype=jnp.int32)[None], (2, 40))
        want, _ = jblocks.apply_attention(jcfg, jblk["attn"], jnp.asarray(x),
                                          pos, window=window)
        got, _ = tblocks.apply_attention(tcfg, layer.attn, _t(x),
                                         window=window)
        assert _rel(want, got) < 1e-5
        want = jblocks.apply_ffn(jcfg, jblk["ffn"], jnp.asarray(x),
                                 kind=jcfg.ffn_kind)
        got = tblocks.apply_ffn(tcfg, layer.ffn, _t(x), kind=tcfg.ffn_kind)
        assert _rel(want, got) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_cache_matches_reference(models, arch):
    """40 one-token steps into caches of max_len 40: a local layer's
    rotating buffer (32 slots) wraps."""
    rng = np.random.default_rng(3)
    jcfg = models(arch)[0]
    step = jax.jit(jblocks.apply_attention, static_argnums=(0,),
                   static_argnames=("window",))
    for i in range(len(jcfg.block_pattern)):
        jcfg, tcfg, jblk, layer, window = _block(models, arch, i)
        spec = jblocks.init_attn_cache(jcfg, 2, 40, window)
        jc = {n: jnp.zeros(s.shape, jnp.float32) for n, s in spec.items()}
        tc = tblocks.init_attn_cache(tcfg, 2, 40, window, device=CPU,
                                     dtype=torch.float32)
        assert tuple(tc["k"].shape) == spec["k"].shape
        for t in range(40):
            x = rng.normal(0, 1, (2, 1, jcfg.d_model)).astype(np.float32)
            want, jc = step(jcfg, jblk["attn"], jnp.asarray(x),
                            jnp.full((2, 1), t, jnp.int32), jc, window=window)
            got, tc = tblocks.apply_attention(
                tcfg, layer.attn, _t(x), torch.full((2, 1), t,
                                                    dtype=torch.int32),
                tc, window=window)
            assert _rel(want, got) < 1e-5, (i, t)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   rtol=1e-5, atol=1e-5)


# -- (e) the slice: prefill and 48 decode steps -------------------------------

def _slice_errors(models, arch, dtype, width_scaled=False):
    jcfg, tcfg, jp, _, tp = models(arch, dtype, width_scaled)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (2, 48)).astype(np.int32)
    want = jax.jit(j_prefill_step(jcfg))(jp, {"inputs": jnp.asarray(toks)})
    got = make_prefill_step(tcfg, CPU)(tp, {"inputs": toks})
    assert tuple(got.shape) == (2, 1, jcfg.vocab)
    assert got.dtype == tcfg.dtype("compute")
    errs = [_rel(want, got.float())]
    jserve = jax.jit(j_serve_step(jcfg))
    serve = make_serve_step(tcfg, CPU)
    jc = jlm.init_caches(jcfg, 2, 48)
    tc = tlm.init_caches(tcfg, 2, 48, device=CPU)
    for t in range(48):
        want, jc = jserve(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        got, tc = serve(tp, tc, toks[:, t:t + 1])
        assert got.dtype == torch.float32 and tuple(got.shape) == (
            2, jcfg.vocab)
        errs.append(_rel(want, got))
    assert int(tc["pos"]) == 48
    return errs


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_float32_matches_reference(models, arch):
    errs = _slice_errors(models, arch, "float32")
    assert max(errs) < F32_REL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_bf16_matches_reference(models, arch):
    """bf16 at the bound of BF16_REL, on weights at 1/sqrt(input width);
    the float32 test above is the parity check on the reference's draw."""
    errs = _slice_errors(models, arch, "bfloat16", width_scaled=True)
    assert max(errs) < BF16_REL, errs


def test_prefill_refuses_other_positions(models):
    jcfg, tcfg, _, _, tp = models("gemma2_9b")
    toks = torch.zeros((2, 8), dtype=torch.int32)
    ar = torch.arange(8, dtype=torch.int32).expand(2, 8)
    h1, _ = tlm.forward(tcfg, tp, toks)
    h2, _ = tlm.forward(tcfg, tp, toks, ar)
    assert torch.equal(h1, h2)
    with pytest.raises(ValueError, match="positions"):
        tlm.forward(tcfg, tp, toks, ar + 1)


# -- (f) params_from_numpy -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_bit_for_bit(models, arch):
    jcfg, tcfg, _, tree, tp = models(arch, "bfloat16")
    got = dict(tp.named_parameters())
    n = 0
    width = len(jcfg.block_pattern)
    for key, blk in tree["body"].items():
        i = int(key[1:key.index("_")])
        for part, leaves in blk.items():
            for name, a in leaves.items():
                for c in range(jcfg.cycles):
                    t = got[f"layers.{c * width + i}.{part}.{name}"]
                    assert t.dtype == torch.bfloat16
                    assert np.array_equal(
                        t.view(torch.int16).numpy(),
                        np.asarray(a[c]).view(np.int16))
                    n += 1
    for name in ("embed", "final_norm"):
        assert np.array_equal(got[name].view(torch.int16).numpy(),
                              np.asarray(tree[name]).view(np.int16))
        n += 1
    assert n == len(got)


def test_params_from_numpy_refuses_bad_trees(models):
    _, tcfg, _, tree, _ = models("gemma2_9b", "bfloat16")
    missing = dict(tree, body={k: dict(v) for k, v in tree["body"].items()})
    blk = next(iter(missing["body"]))
    missing["body"][blk] = dict(missing["body"][blk],
                                attn={k: v for k, v in
                                      missing["body"][blk]["attn"].items()
                                      if k != "wq"})
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tcfg, missing, device=CPU)
    with pytest.raises(ValueError, match="left over"):
        params_from_numpy(tcfg, dict(tree, head=tree["embed"].T), device=CPU)
    with pytest.raises(ValueError, match="left over"):
        params_from_numpy(tcfg, dict(tree, extra=tree["final_norm"]),
                          device=CPU)
    with pytest.raises(TypeError):
        params_from_numpy(tcfg.replace(param_dtype="float32"), tree,
                          device=CPU)


# -- (g) the full width on the meta device -------------------------------------

def test_gemma2_full_width_on_meta():
    tcfg, jcfg = TC.get("gemma2_9b"), JC.get("gemma2_9b")
    model = tlm.init_params(tcfg, torch.Generator(), device="meta")
    assert tlm.count_params(model) == 9_241_705_984
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {}
    plan = jax.tree_util.tree_flatten_with_path(
        jlm.plan_model(jcfg),
        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]
    width = len(jcfg.block_pattern)
    for path, spec in plan:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[0] == "body":
            i = int(keys[1][1:keys[1].index("_")])
            for c in range(jcfg.cycles):
                want[f"layers.{c * width + i}.{keys[2]}.{keys[3]}"] = \
                    tuple(spec.shape[1:])
        else:
            want[".".join(map(str, keys))] = tuple(spec.shape)
    assert got == want


def test_configs_match_reference():
    for arch in ARCHS:
        t, j = TC.get(arch), JC.get(arch)
        for f in ModelConfig.__dataclass_fields__:
            want = getattr(j, f)
            if dataclasses.is_dataclass(want):   # sharding: by value
                assert dataclasses.asdict(getattr(t, f)) == \
                    dataclasses.asdict(want), (arch, f)
            else:
                assert getattr(t, f) == want, (arch, f)
        assert t.dtype("compute") == torch.bfloat16
    assert TC.get("qwen3-1.7b").name == "qwen3-1.7b"
    for arch in ("deepseek_v3_671b", "llama4_scout_17b_a16e"):
        t, j = TC.get(arch), JC.get(arch)
        assert t.family == j.family == "moe"
        assert (t.moe.num_experts, t.moe.top_k, t.d_ff_dense) == \
            (j.moe.num_experts, j.moe.top_k, j.d_ff_dense)
        assert t.dtype("compute") == torch.bfloat16
