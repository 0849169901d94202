"""MLA and MoE against the JAX package, on the CPU: DeepSeek-V3 (three
``mla_dense`` prefix layers, ``attn_moe`` with MLA, MTP) and Llama 4 Scout
(``attn_moe`` with GQA), and the flash wrapper's plain version at a v
head dim of its own.

The same inputs, made with numpy from a seed, go through ``repro`` (the
reference) and ``repro_torch``; the port's weights are the reference's,
carried across by ``params_from_numpy``.  Weights are drawn with numpy,
every matrix at 1/sqrt(its input width) (``_draw``), with no
``init_params`` compile.  Smoke width is the reference's ``smoke_config``
(DeepSeek 4 layers, Llama 4 two; 4 experts, top 2 and top 1).

Bounds: the flash plain version within 1e-5 of ``mha_ref`` (float32, the
same formula); blocks within 1e-5 of the largest |output|, and the MoE's
expert ids and kept slots equal; the slice's logits within 2e-4 of the
largest |logit| in float32 (the reference's own bound for this family,
``tests/test_models.py``), decode against the port's own prefill
likewise; caches within 1e-5 in float32 and 3e-2 in bf16; weights bit for
bit.  The slices run 2 x 16 tokens: 32 tokens sit under the capacity's
floor of min(N, 32) slots an expert, so neither the prefill nor a decode
step drops a slot, and the two paths route alike.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.kernels.ref import mha_ref
from repro.launch import roofline as jroofline
from repro.launch import train as jtrain
from repro.launch.steps import make_prefill_step as j_prefill_step
from repro.launch.steps import make_serve_step as j_serve_step
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models.config import MLAConfig as JMLA
from repro.models.config import smoke_config as j_smoke

import repro_torch.configs as TC
from repro_torch.kernels.flash_attention import flash_attention, kernel_for
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models.config import MLAConfig as TMLA
from repro_torch.models.config import ModelConfig
from repro_torch.models.config import smoke_config as t_smoke
from repro_torch.models.transfer import (
    params_from_numpy, params_to_numpy, to_reference_tree,
)

CPU = "cpu"
ARCHS = ("deepseek_v3_671b", "llama4_scout_17b_a16e")
# the case "deepseek_v3_671b@192": MLA's true head dims (q.k 128 + 64, v
# 128) on 2 heads
TRUE_MLA = dict(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128)
F32_REL = 2e-4
BF16_REL = 3e-2
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: without this, 6 pytest-xdist workers on 8
    cores slow them several-fold by intra-op fan-out."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _cfgs(case, dtype="float32"):
    arch, _, hd = case.partition("@")
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg, tcfg = j_smoke(JC.get(arch)), t_smoke(TC.get(arch))
    if hd:
        jcfg = jcfg.replace(n_heads=2, n_kv_heads=2, mla=JMLA(**TRUE_MLA))
        tcfg = tcfg.replace(n_heads=2, n_kv_heads=2, mla=TMLA(**TRUE_MLA))
    return jcfg.replace(**kw), tcfg.replace(**kw)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1.0, np.abs(a).max()))


def _draw(jcfg, seed):
    """The reference's tree (``lm.plan_model``), drawn with numpy in
    float32: norms as their init, every matrix normal at 1/sqrt(its input
    width), body leaves stacked on cycles.  The input width is the first
    axis of the unstacked leaf, the first two of ``wo`` [H, hd, d], and
    the second of the experts' ``w_in`` [E, d, 2ff] and ``w_out`` [E, ff,
    d]."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        keys = [getattr(p, "key", None) for p in path]
        shape = spec.shape[1:] if keys[0] == "body" else spec.shape
        width = shape[0] * shape[1] if keys[-1] == "wo" else \
            shape[1] if keys[-2:-1] == ["moe"] and len(shape) == 3 \
            else shape[0]
        return (rng.standard_normal(spec.shape, np.float32)
                / np.float32(np.sqrt(width)))
    return jax.tree_util.tree_map_with_path(
        leaf, jlm.plan_model(jcfg),
        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))


@pytest.fixture(scope="module")
def models():
    """Per (case, dtype): the reference's params and the port's copy; bf16
    is the float32 draw rounded."""
    draws, cache = {}, {}

    def get(case, dtype="float32"):
        if (case, dtype) not in cache:
            if case not in draws:
                draws[case] = _draw(_cfgs(case)[0], 3)
            jcfg, tcfg = _cfgs(case, dtype)
            tree = jax.tree.map(lambda a: a.astype(jcfg.dtype("param")),
                                draws[case])
            cache[case, dtype] = (jcfg, tcfg,
                                  jax.tree.map(jnp.asarray, tree), tree,
                                  params_from_numpy(tcfg, tree, device=CPU))
        return cache[case, dtype]
    return get


@functools.lru_cache(maxsize=None)
def _jitted(make, jcfg):
    return jax.jit(make(jcfg))


def _ref_layer(jcfg, tree, i):
    """Layer i of a reference tree (params or caches): a prefix block, a
    body leaf's slice of its cycle, or a remainder block."""
    n_pre, width = len(jcfg.prefix_blocks), len(jcfg.block_pattern)
    if i < n_pre:
        return tree["prefix"][i]
    j = i - n_pre
    if j >= jcfg.cycles * width:
        return tree["rem"][j - jcfg.cycles * width]
    key = f"b{j % width}_{jcfg.block_pattern[j % width]}"
    return jax.tree.map(lambda a: a[j // width], tree["body"][key])


# -- configs ------------------------------------------------------------------

def _assert_same_config(t, j, what):
    """Every field of the port's config as the reference's, the
    sub-configs by value."""
    for f in ModelConfig.__dataclass_fields__:
        want = getattr(j, f)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(getattr(t, f)) == \
                dataclasses.asdict(want), (what, f)
        else:
            assert getattr(t, f) == want, (what, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Every field, the sub-configs by value, the cells, the smoke
    config's MoE and MLA."""
    t, j = TC.get(arch), JC.get(arch)
    _assert_same_config(t, j, arch)
    assert TC.get(arch.replace("_", "-")) is t
    assert [c.name for c in TC.shape_cells(t)] == \
        [c.name for c in JC.shape_cells(j)] == \
        ["train_4k", "prefill_32k", "decode_32k"]
    ts, js = t_smoke(t), j_smoke(j)
    for f in ("moe", "mla", "d_ff_dense", "n_layers"):
        a, b = getattr(ts, f), getattr(js, f)
        assert (dataclasses.asdict(a) if dataclasses.is_dataclass(a)
                else a) == (dataclasses.asdict(b)
                            if dataclasses.is_dataclass(b) else b), f


@pytest.mark.parametrize("arch", ARCHS)
def test_preset_100m_matches_reference(arch):
    """``launch.train.preset_config(..., "100m")`` field by field as the
    reference's (8 experts of 768, DeepSeek's MLA at q.k 64 + 32 and v
    64); the flash kernel serves the MLA pair on both routes."""
    t = ttrain.preset_config(TC.get(arch), "100m")
    _assert_same_config(t, jtrain.preset_config(JC.get(arch), "100m"),
                        arch)
    assert t.moe.num_experts == 8 and t.moe.d_ff_expert == 768
    if t.mla is not None:
        pair = (t.mla.qk_nope_head_dim + t.mla.qk_rope_head_dim,
                t.mla.v_head_dim)
        assert pair == (96, 64)
        assert kernel_for(*pair, torch.bfloat16) == "wgmma"
        assert kernel_for(*pair, torch.float32) == "f32"


# -- the flash wrapper at a v head dim of its own -----------------------------

@pytest.mark.parametrize("hd,vd", [(192, 128), (96, 64), (24, 16)])
def test_flash_ref_matches_mha_ref_split_dims(hd, vd):
    """MLA's pair (q.k 192, v 128), the 100m preset's (96, 64) and the
    smoke MLA's (24, 16), causal, GQA, S 100 (no multiple of a tile): the
    plain version against the reference's ``mha_ref`` within 1e-5, [B, H,
    S, vd] out; the wrapper takes it for CPU tensors at any pair."""
    rng = np.random.default_rng(hd)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32) for shape in
               ((2, 4, 100, hd), (2, 2, 100, hd), (2, 2, 100, vd)))
    want = np.asarray(mha_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v)))
    got = flash_attention_ref(_t(q), _t(k), _t(v))
    assert tuple(got.shape) == (2, 4, 100, vd)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert torch.equal(flash_attention(_t(q), _t(k), _t(v)), got)
    # a CUDA tensor gets a kernel at MLA's pairs on both routes, none at
    # the smoke pair
    served = (hd, vd) != (24, 16)
    assert (kernel_for(hd, vd, torch.bfloat16) == "wgmma") == served
    assert (kernel_for(hd, vd, torch.float32) == "f32") == served


# -- blocks -------------------------------------------------------------------

def _mla_layer(models, case):
    jcfg, tcfg, _, tree, tp = models(case)
    jp = jax.tree.map(jnp.asarray, _ref_layer(jcfg, tree, 0)["attn"])
    return jcfg, tcfg, jp, tp.layers[0].attn


@pytest.mark.parametrize("case", ["deepseek_v3_671b",
                                  "deepseek_v3_671b@192"])
def test_mla_matches_reference(models, case):
    """MLA cache-less over 40 tokens (the flash wrapper at (24, 16) or
    (192, 128)), then 8 absorbed steps through its latent cache, float32:
    outputs and the cache after every step within 1e-5."""
    jcfg, tcfg, jp, tpart = _mla_layer(models, case)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (B, 40, jcfg.d_model)).astype(np.float32)
    step = jax.jit(jblocks.apply_mla, static_argnums=(0,))
    pos = jnp.broadcast_to(jnp.arange(40, dtype=jnp.int32)[None], (B, 40))
    want, _ = step(jcfg, jp, jnp.asarray(x), pos)
    got, _ = tblocks.apply_mla(tcfg, tpart, _t(x))
    assert _rel(want, got) < 1e-5
    jc = {n: jnp.zeros(s.shape, jnp.float32)
          for n, s in jblocks.init_mla_cache(jcfg, B, 40).items()}
    tc = tblocks.init_mla_cache(tcfg, B, 40, device=CPU,
                                dtype=torch.float32)
    assert {n: tuple(t.shape) for n, t in tc.items()} == \
        {n: tuple(a.shape) for n, a in jc.items()}
    for t in range(8):
        jpos = jnp.full((B, 1), t, jnp.int32)
        want, jc = step(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jpos, jc)
        got, back = tblocks.apply_mla(tcfg, tpart, _t(x[:, t:t + 1]),
                                      torch.full((B, 1), t), tc)
        assert back is tc
        assert _rel(want, got) < 1e-5, t
        for n in jc:
            assert _rel(jc[n], tc[n]) < 1e-5, (t, n)


def _reference_moe(jcfg, jp, x, monkeypatch):
    """The reference's ``apply_moe_gather`` run op by op, with its expert
    ids (``jax.lax.top_k``'s) and slot positions (``take_along_axis``'s)
    recorded on the way."""
    seen = {}
    top_k, take = jax.lax.top_k, jnp.take_along_axis

    def spy_top_k(a, k):
        out = top_k(a, k)
        seen["eid"] = np.asarray(out[1])
        return out

    def spy_take(a, idx, axis):
        out = take(a, idx, axis=axis)
        seen["pos"] = np.asarray(out)[..., 0]
        return out
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", spy_top_k)
        m.setattr(jnp, "take_along_axis", spy_take)
        y = jblocks.apply_moe_gather(jcfg, jp, jnp.asarray(x))
    return np.asarray(y), seen["eid"], seen["pos"]


@pytest.mark.parametrize("router", ["drawn", "skewed", "tied"])
def test_moe_matches_reference(models, router, monkeypatch):
    """DeepSeek's smoke MoE (4 experts, top 2, one shared) on 2 x 40
    tokens, float32, at a capacity of 50 slots an expert: the router as
    drawn, skewed so that every token's first choice is expert 0 (80 slots
    for 50: at least 30 dropped), and all zeros (every probability equal:
    the reference's top_k takes experts 0 and 1, and 30 of each drop).
    Expert ids, slot positions and the kept slots equal the reference's,
    the output within 1e-5."""
    jcfg, tcfg, _, tree, tp = models("deepseek_v3_671b")
    i = tcfg.layer_kinds.index("attn_moe")
    jp = dict(_ref_layer(jcfg, tree, i)["moe"])
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (B, 40, jcfg.d_model)).astype(np.float32)
    if router == "skewed":
        u = rng.normal(0, 1, jcfg.d_model).astype(np.float32)
        u /= np.linalg.norm(u)
        x += 4 * np.sqrt(jcfg.d_model) * u
        jp["router"] = jp["router"].copy()
        jp["router"][:, 0] = 8 * u
    elif router == "tied":
        jp["router"] = np.zeros_like(jp["router"])
    want, jeid, jpos = _reference_moe(jcfg, jax.tree.map(jnp.asarray, jp),
                                      x, monkeypatch)
    tpart = tblocks.Params({n: _t(a) for n, a in jp.items()})
    tokens = tblocks.rms_norm(_t(x), tpart.norm, tcfg.norm_eps).reshape(
        -1, jcfg.d_model)
    gate, eid = tblocks.moe_route(tcfg, tpart.router, tokens)
    pos = tblocks.moe_slots(eid, tcfg.moe.num_experts)
    np.testing.assert_array_equal(eid.numpy(), jeid)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    cap = tblocks.moe_capacity(tcfg, B * 40)
    assert cap == 50
    kept = (pos < cap).numpy()
    assert np.array_equal(kept, jpos < cap)
    if router != "drawn":
        assert int((~kept).sum()) >= 30
    if router == "tied":
        assert (jeid == [0, 1]).all()
    got = tblocks.apply_moe(tcfg, tpart, _t(x))
    assert _rel(want, got) < 1e-5


# -- the slice: prefill and decode --------------------------------------------

def _slice_errors(models, case, dtype):
    jcfg, tcfg, jp, _, tp = models(case, dtype)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    want = _jitted(j_prefill_step, jcfg)(jp, {"inputs": jnp.asarray(toks)})
    got = tsteps.make_prefill_step(tcfg, CPU)(tp, {"inputs": toks})
    assert tuple(got.shape) == (B, 1, jcfg.vocab)
    errs = [_rel(want, got.float())]
    jserve = _jitted(j_serve_step, jcfg)
    serve = tsteps.make_serve_step(tcfg, CPU)
    jc = jlm.init_caches(jcfg, B, S)
    tc = tlm.init_caches(tcfg, B, S, device=CPU)
    for t in range(S):
        want, jc = jserve(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        got, tc = serve(tp, tc, toks[:, t:t + 1])
        errs.append(_rel(want, got))
    return errs, jax.tree.map(np.asarray, jc), tc


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_float32_matches_reference(models, arch):
    """The prefill's last logits and 16 decode steps, float32, within
    2e-4; then every layer's cache after them: the reference's keys
    (``latent`` and ``k_rope`` for MLA layers, ``k`` and ``v`` for GQA),
    shapes, dtypes and values within 1e-5."""
    errs, jtree, tc = _slice_errors(models, arch, "float32")
    assert max(errs) < F32_REL, errs
    jcfg = models(arch)[0]
    assert int(tc["pos"]) == int(jtree["pos"]) == S
    for i, layer in enumerate(tc["layers"]):
        want = _ref_layer(jcfg, jtree, i)
        assert want.keys() == layer.keys() == {"attn"}, i
        assert want["attn"].keys() == layer["attn"].keys() == (
            {"latent", "k_rope"} if jcfg.mla else {"k", "v"}), i
        for n, a in want["attn"].items():
            got = layer["attn"][n]
            assert got.dtype == torch.float32 and tuple(got.shape) == \
                a.shape, (i, n)
            assert _rel(a, got) < 1e-5, (i, n)


def test_slice_bf16_caches(models):
    """DeepSeek in bf16: the latent caches in bf16, as the reference's
    ``init_caches`` (the compute dtype), within 3e-2 of its values after
    16 decode steps, and the logits within 3e-2."""
    errs, jtree, tc = _slice_errors(models, "deepseek_v3_671b", "bfloat16")
    assert max(errs) < BF16_REL, errs
    jcfg = models("deepseek_v3_671b")[0]
    for i, layer in enumerate(tc["layers"]):
        for n, a in _ref_layer(jcfg, jtree, i)["attn"].items():
            got = layer["attn"][n]
            assert got.dtype == torch.bfloat16 and a.dtype.name == \
                "bfloat16", (i, n)
            assert _rel(a.astype(np.float32), got.float()) < BF16_REL, (i, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(models, arch):
    """The port's decode logits, a token at a time through the caches
    (MLA absorbed), against its own cache-less forward (MLA expanded, the
    flash wrapper), float32, within 2e-4: the reference's own check
    (``tests/test_models.py``)."""
    _, tcfg, _, _, tp = models(arch)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        hidden, _ = tlm.forward(tcfg, tp, toks)
        full = tlm.logits_fn(tcfg, tp, hidden)
    serve = tsteps.make_serve_step(tcfg, CPU)
    caches = tlm.init_caches(tcfg, B, S, device=CPU)
    scale = max(1.0, float(full.abs().max()))
    for t in range(S):
        logits, caches = serve(tp, caches, toks[:, t:t + 1])
        assert float((logits - full[:, t]).abs().max()) / scale < F32_REL, t


# -- loss and gradients ---------------------------------------------------------

# case -> (arch, loss_chunk); DeepSeek's smoke config keeps its MTP head
GRAD_CASES = {"deepseek_v3_671b": ("deepseek_v3_671b", 0),
              "deepseek_v3_671b-chunked": ("deepseek_v3_671b", 8),
              "llama4_scout_17b_a16e": ("llama4_scout_17b_a16e", 0)}


@pytest.fixture(scope="module")
def ref_grads(models):
    """Per case: ``jax.value_and_grad(lm.lm_loss)`` under ``jax.jit`` on
    the module's float32 draw (remat none), its loss, gradients and the
    expert ids of every ``jax.lax.top_k`` its forward ran, recorded by a
    debug callback; with the port's config (remat full) and the batch."""
    out = {}
    top_k = jax.lax.top_k
    for case, (arch, chunk) in GRAD_CASES.items():
        jcfg, tcfg, jp, _, _ = models(arch)
        jcfg = jcfg.replace(loss_chunk=chunk, remat="none")
        rng = np.random.default_rng(5)
        toks = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
                 "mask": rng.random((B, S)) < 0.9}
        ids = []

        def spy(a, k):
            res = top_k(a, k)
            jax.debug.callback(lambda e: ids.append(np.asarray(e)), res[1])
            return res
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.lax, "top_k", spy)
            loss, grads = jax.jit(jax.value_and_grad(functools.partial(
                jlm.lm_loss, jcfg)))(jp, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
            jax.effects_barrier()
        out[case] = (tcfg.replace(loss_chunk=chunk, remat="full"),
                     jax.tree.map(np.asarray, jp), batch, float(loss),
                     jax.tree.map(np.asarray, grads), ids)
    return out


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_lm_loss_and_gradients_match_reference(ref_grads, case):
    """The port's loss and gradients (remat full: each layer recomputed
    in the backward, MLA's attention through ``FlashAttend``'s dense
    recompute, the MoE's dispatch by autograd) against the reference's on
    DeepSeek-V3 (3 mla_dense layers, an attn_moe, MTP; the loss whole and
    in chunks of 8) and Llama 4 Scout: the loss within 1e-5, every
    gradient leaf within 1e-4 of its largest |value|, and the expert ids of
    every MoE layer equal to the reference's, in the forward and again in
    the backward's recompute.

    Llama 4's router routes top 1, and the gate renormalised over one
    expert is p / p = 1 whatever the router: its gradient is 0 in both
    packages but for rounding (about 5e-9 in each, of a largest gradient
    near 0.6), so there the two are held to be below 1e-7 of the model's
    largest gradient instead, and only there."""
    from repro_torch.launch.ranks import RoutingProbe
    tcfg, jp, batch, jloss, jgrads, jids = ref_grads[case]
    with RoutingProbe() as probe:
        model = params_from_numpy(tcfg, jp, CPU, trainable=True)
        loss = tlm.lm_loss(tcfg, model, {k: torch.as_tensor(v)
                                         for k, v in batch.items()})
        n_fwd = len(probe.eids)
        loss.backward()
    ids = [e.numpy() for e in probe.eids]
    assert abs(float(loss.detach()) - jloss) <= 1e-5
    n_moe = tcfg.layer_kinds.count("attn_moe")
    assert len(jids) == n_fwd == n_moe and len(ids) == 2 * n_moe
    for got, want in zip(ids[:n_fwd], jids):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ids[n_fwd:], ids[n_fwd - 1::-1]):
        np.testing.assert_array_equal(got, want)
    got = jax.tree.leaves(to_reference_tree(
        tcfg, {n: p.grad for n, p in model.named_parameters()}))
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(got) == len(want)
    floor = 1e-7 * max(float(np.abs(a).max()) for _, a in want)
    zero = []
    for (path, a), g in zip(want, got):
        a = np.asarray(a, np.float64)
        if np.abs(a).max() <= floor:
            zero.append(jax.tree_util.keystr(path))
            assert np.abs(g.numpy()).max() <= floor, (zero[-1], floor)
            continue
        err = np.abs(a - g.numpy()).max() / max(np.abs(a).max(), 1e-30)
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)
    assert zero == ([k for k in map(jax.tree_util.keystr, (
        p for p, _ in want)) if k.endswith("['router']")]
        if tcfg.moe.top_k == 1 else []), zero


# -- weights across -----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bit_for_bit(models, arch):
    """bf16 weights in and out bit for bit: DeepSeek's prefix list (MLA and
    the dense FFN at d_ff_dense), the MoE and MLA leaves of the body, MTP;
    Llama 4's body of two cycles."""
    jcfg, tcfg, jp, tree, tp = models(arch, "bfloat16")
    assert len(tree["prefix"]) == len(jcfg.prefix_blocks)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back = params_to_numpy(tcfg, tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for (path, a), b in zip(flat, jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a).view(np.uint16), b), \
            jax.tree_util.keystr(path)
    assert sum(a.size for _, a in flat) == tlm.count_params(tp)


# -- full width on meta -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_on_meta(arch):
    """Every parameter's name and shape as the reference's plan (prefix,
    body, MTP), and the count as its ``roofline.model_params``:
    671,642,988,544 and 107,769,861,120."""
    tcfg, jcfg = TC.get(arch), JC.get(arch)
    model = tlm.init_params(tcfg, torch.Generator(), device="meta")
    n = tlm.count_params(model)
    assert n == jroofline.model_params(jcfg) == {
        "deepseek_v3_671b": 671_642_988_544,
        "llama4_scout_17b_a16e": 107_769_861_120}[arch]
    got = {nm: tuple(p.shape) for nm, p in model.named_parameters()}
    want = {}
    n_pre, width = len(jcfg.prefix_blocks), len(jcfg.block_pattern)
    plan = jax.tree_util.tree_flatten_with_path(
        jlm.plan_model(jcfg),
        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]
    for path, spec in plan:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[0] == "body":
            k = int(keys[1][1:keys[1].index("_")])
            for c in range(jcfg.cycles):
                want[f"layers.{n_pre + c * width + k}.{keys[2]}."
                     f"{keys[3]}"] = tuple(spec.shape[1:])
        elif keys[0] == "prefix":
            want[f"layers.{keys[1]}.{keys[2]}.{keys[3]}"] = tuple(spec.shape)
        else:
            want[".".join(map(str, keys))] = tuple(spec.shape)
    assert got == want
    caches = tlm.init_caches(tcfg, 1, 32768, device="meta")
    first = caches["layers"][0]["attn"]
    assert {n: tuple(t.shape) for n, t in first.items()} == (
        {"latent": (1, 32768, 512), "k_rope": (1, 32768, 64)}
        if jcfg.mla else {"k": (1, 32768, 8, 128), "v": (1, 32768, 8, 128)})


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "llama4_scout_17b_a16e"])
def test_serve_lm_routes_and_every_position(models, arch):
    """``launch.ranks.serve_lm(..., routes=True)``, as phase 15 (f) of
    ``chip_smoke.py`` serves the MoE archs: the prefill's logits at every
    position (``lm.prefill(..., every=True)``) against the last-token
    prefill and each prefix's prefill, the experts of each MoE layer
    (``RoutingProbe``) against a forward's, the decode's against the
    prefill's at the same positions; then ``chip_smoke.held_positions``
    on those routes and on routes parted at one position: in the model's
    last layer only that position drops, in an earlier MoE layer every
    later one of the request."""
    import chip_smoke
    from repro_torch.launch.ranks import RoutingProbe, serve_lm
    _, tcfg, _, _, model = models(arch)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab, (B, S)).astype(np.int32))
    out = serve_lm(tcfg, model, toks, 4, torch.device(CPU), routes=True)
    every, routes = out["logits"]["prefill_every"], out["logits"]["routes"]
    assert every.shape == (B, S, tcfg.vocab)
    assert _rel(every[:, -1], out["logits"]["prefill"][:, 0]) <= 1e-6
    for t in (0, 5):
        short = tlm.prefill(tcfg, model, toks[:, :t + 1])
        assert _rel(every[:, t], short[:, 0]) <= 1e-6
    moe_at = [i for i, k in enumerate(tcfg.layer_kinds) if k == "attn_moe"]
    with torch.inference_mode(), RoutingProbe() as probe:
        tlm.forward(tcfg, model, toks)
    assert len(routes["prefill"]) == len(moe_at) == len(probe.eids)
    for got, want in zip(routes["prefill"], probe.eids):
        assert torch.equal(got, want)
    for t, step in enumerate(routes["decode"]):
        for got, want in zip(step, routes["prefill"]):
            assert torch.equal(got.sort(-1).values,
                               want.view(B, S, -1)[:, t].sort(-1).values)
    held, before = chip_smoke.held_positions(tcfg, routes["prefill"],
                                             routes["prefill"], B)
    assert bool(held.all()) and before.tolist() == [S, S]
    for layer, at in enumerate(moe_at):
        parted = [e.clone() for e in routes["prefill"]]
        e = parted[layer]
        e[S + 6] = (e[S + 6] + 1) % tcfg.moe.num_experts   # request 1, pos 6
        held, before = chip_smoke.held_positions(tcfg, parted,
                                                 routes["prefill"], B)
        assert bool(held[0].all()) and before.tolist() == [S, 6]
        lost = ~held[1]
        if at == tcfg.n_layers - 1:
            assert lost.nonzero().flatten().tolist() == [6], lost
        else:
            assert lost.nonzero().flatten().tolist() == list(range(6, S))
