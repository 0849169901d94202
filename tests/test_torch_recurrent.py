"""The recurrent archs against the JAX package, on the CPU: RecurrentGemma
2B (RG-LRU with its causal conv, local MQA attention, GeGLU) and xLSTM
125M (mLSTM and sLSTM blocks).

The same inputs, made with numpy from a seed, go through ``repro`` (the
reference) and ``repro_torch``; the port's weights are the reference's,
carried across by ``params_from_numpy``.  Smoke width is the reference's
``smoke_config``; RecurrentGemma runs 5 layers, one cycle of (rec, rec,
attn_local) and the unstacked remainder (rec, rec), and also at its true
hd 256 (``@256``), so that the flash wrapper's plain version runs there;
xLSTM runs 4 layers, two cycles of (mlstm, slstm).

Bounds, as ``tests/test_torch_archs.py`` states them: blocks within 1e-5
of the largest |output|; the slice (prefill, 48 decode steps) within 2e-4
of the largest |logit| in float32 and 3e-2 in bf16 on matrices at
1/sqrt(input width); the loss within 1e-5 and every gradient leaf within
1e-4 of its largest |value|; weights bit for bit.  The port's decode
against its own prefill: the reference's 1e-3 for the hybrid and xlstm
families (``tests/test_models.py``).
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.launch import roofline as jroofline
from repro.launch.steps import make_prefill_step as j_prefill_step
from repro.launch.steps import make_serve_step as j_serve_step
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models.config import smoke_config as j_smoke

import repro_torch.configs as TC
from repro_torch.launch import steps as tsteps
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.models.config import smoke_config as t_smoke
from repro_torch.models.transfer import (
    params_from_numpy, params_to_numpy, to_reference_tree,
)

CPU = "cpu"
ARCHS = ("recurrentgemma_2b", "xlstm_125m")
LAYERS = {"recurrentgemma_2b": 5, "xlstm_125m": 4}
# "arch" at smoke width, "arch@hd" with that head dim
CASES = ("recurrentgemma_2b", "recurrentgemma_2b@256", "xlstm_125m")
F32_REL = 2e-4
BF16_REL = 3e-2
DECODE_REL = 1e-3
STEPS = 48
B, S = 2, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops (a step a token): without this, 6 pytest-xdist
    workers on 8 cores slow them several-fold by intra-op fan-out."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _cfgs(case, dtype="float32", **kw):
    arch, _, hd = case.partition("@")
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **kw)
    kw.setdefault("n_layers", LAYERS[arch])
    if hd:
        kw["head_dim"] = int(hd)
    return (j_smoke(JC.get(arch)).replace(**kw),
            t_smoke(TC.get(arch)).replace(**kw))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1.0, np.abs(a).max()))


def _width_scaled(jcfg, tree):
    """Every matrix at 1/sqrt(its input width), as
    ``chip_smoke.parity_model`` draws them: body leaves carry the cycles
    axis, which the reference's draw reads as fan-in; sLSTM's ``r_gates``
    [4, H, dh, dh] contract over dh.  ``tree`` holds numpy arrays."""
    def rescale(path, a):
        key = path[-1].key
        if a.ndim < 3:                  # norms, biases, lam: as drawn
            return a
        width = a.shape[-1] if key == "r_gates" else \
            a.shape[1] * a.shape[2] if key == "wo" else a.shape[1]
        return (a.astype(np.float32) * np.sqrt(jcfg.cycles / width)).astype(
            a.dtype)
    return {**tree, "body": jax.tree_util.tree_map_with_path(rescale,
                                                             tree["body"])}


def _draw(jcfg, seed):
    """The reference's distribution (``common.tree_init``: zeros, ones, or
    normal at 1/sqrt(shape[0]), body leaves stacked on cycles), drawn
    with numpy in float32: the same tree as ``lm.init_params`` without
    its compiles."""
    rng = np.random.default_rng(seed)

    def leaf(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        return (rng.standard_normal(spec.shape, np.float32)
                / np.float32(np.sqrt(max(spec.shape[0], 1))))
    return jax.tree.map(leaf, jlm.plan_model(jcfg),
                        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))


@pytest.fixture(scope="module")
def models():
    """Per (case, dtype, draw, depth): the reference's params and the
    port's copy.  Each case is drawn once (float32, at ``LAYERS``): bf16
    is that draw rounded, as the reference's own bf16 draw is; the smoke
    depth keeps the first cycles of the body and drops the remainder."""
    draws, cache = {}, {}

    def get(case, dtype="float32", width_scaled=False, smoke_depth=False):
        key = case, dtype, width_scaled, smoke_depth
        if key not in cache:
            if case not in draws:
                jcfg = _cfgs(case)[0]
                draws[case] = _draw(jcfg, 3)
            tree = draws[case]
            if width_scaled:
                tree = _width_scaled(_cfgs(case)[0], tree)
            kw = {"n_layers": j_smoke(JC.get(case.partition("@")[0])
                                      ).n_layers} if smoke_depth else {}
            jcfg, tcfg = _cfgs(case, dtype, **kw)
            tree = {**tree, "rem": tree["rem"][:len(jcfg.remainder_blocks)],
                    "body": jax.tree.map(lambda a: a[:jcfg.cycles],
                                         tree["body"])}
            tree = jax.tree.map(lambda a: a.astype(jcfg.dtype("param")),
                                tree)
            cache[key] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree,
                          params_from_numpy(tcfg, tree, device=CPU))
        return cache[key]
    return get


@functools.lru_cache(maxsize=None)
def _jitted(make, jcfg):
    """One compile of the reference's step per config, shared by the
    draws and tests that run it."""
    return jax.jit(make(jcfg))


def _ref_layer(jcfg, tree, i):
    """Layer i of a reference tree (params or caches): a body leaf's slice
    of its cycle, or a remainder block."""
    width = len(jcfg.block_pattern)
    n_body = jcfg.cycles * width
    if i >= n_body:
        return tree["rem"][i - n_body]
    key = f"b{i % width}_{jcfg.block_pattern[i % width]}"
    return jax.tree.map(lambda a: a[i // width], tree["body"][key])


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    t, j = TC.get(arch), JC.get(arch)
    for f in ModelConfig.__dataclass_fields__:
        want = getattr(j, f)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(getattr(t, f)) == \
                dataclasses.asdict(want), (arch, f)
        else:
            assert getattr(t, f) == want, (arch, f)
    assert TC.get(arch.replace("_", "-")) is t
    assert [c.name for c in TC.shape_cells(t)] == \
        [c.name for c in JC.shape_cells(j)]
    assert "long_500k" in [c.name for c in TC.shape_cells(t)]
    ts, js = t_smoke(t).rglru, j_smoke(j).rglru
    assert (ts and dataclasses.asdict(ts)) == (js and dataclasses.asdict(js))


# -- blocks --------------------------------------------------------------------

BLOCKS = {"rec": ("recurrentgemma_2b", 0, "rec"),
          "mlstm": ("xlstm_125m", 0, "cell"),
          "slstm": ("xlstm_125m", 1, "cell")}


def _block_fns(kind):
    if kind == "rec":
        return (jblocks.apply_rglru, tblocks.apply_rglru,
                lambda c: jblocks.init_rglru_cache(c, B),
                lambda c: tblocks.init_rglru_cache(c, B, device=CPU,
                                                   dtype=torch.float32))
    j = getattr(jblocks, f"apply_{kind}"), getattr(tblocks, f"apply_{kind}")
    return j + (lambda c: getattr(jblocks, f"init_{kind}_cache")(c, B),
                lambda c: getattr(tblocks, f"init_{kind}_cache")(
                    c, B, device=CPU))


@pytest.mark.parametrize("kind", BLOCKS)
def test_blocks_match_reference(models, kind):
    """The block cache-less over 40 tokens, then 8 one-token steps through
    its cache, float32, on matrices at 1/sqrt(input width): outputs and
    the cache after every step."""
    arch, i, part = BLOCKS[kind]
    jcfg, tcfg, _, tree, tp = models(arch, width_scaled=True)
    jp = jax.tree.map(jnp.asarray, _ref_layer(jcfg, tree, i)[part])
    tpart = getattr(tp.layers[i], part)
    japply, tapply, jinit, tinit = _block_fns(kind)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (B, 40, jcfg.d_model)).astype(np.float32)
    step = jax.jit(japply, static_argnums=(0,))
    want, _ = step(jcfg, jp, jnp.asarray(x))
    got, _ = tapply(tcfg, tpart, _t(x))
    assert _rel(want, got) < 1e-5
    jc = {n: jnp.zeros(s.shape, jnp.float32)
          for n, s in jinit(jcfg).items()}
    tc = tinit(tcfg)
    assert {n: tuple(t.shape) for n, t in tc.items()} == \
        {n: tuple(a.shape) for n, a in jc.items()}
    for t in range(8):
        want, jc = step(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jc)
        got, back = tapply(tcfg, tpart, _t(x[:, t:t + 1]), tc)
        assert back is tc
        assert _rel(want, got) < 1e-5, t
        for n in jc:
            assert _rel(jc[n], tc[n]) < 1e-5, (t, n)


def test_linear_scan_is_the_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + b_t stepped in
    float64, at a length that is no power of 2."""
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (2, 37, 5))
    b = rng.normal(0, 1, (2, 37, 5))
    h, want = np.zeros((2, 5)), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = tblocks.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


# -- the slice: prefill and decode ------------------------------------------

def _slice_errors(models, case, dtype, width_scaled=False,
                  smoke_depth=False):
    jcfg, tcfg, jp, _, tp = models(case, dtype, width_scaled, smoke_depth)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    want = _jitted(j_prefill_step, jcfg)(jp, {"inputs": jnp.asarray(toks)})
    got = tsteps.make_prefill_step(tcfg, CPU)(tp, {"inputs": toks})
    assert tuple(got.shape) == (B, 1, jcfg.vocab)
    assert got.dtype == tcfg.dtype("compute")
    errs = [_rel(want, got.float())]
    jserve = _jitted(j_serve_step, jcfg)
    serve = tsteps.make_serve_step(tcfg, CPU)
    jc = jlm.init_caches(jcfg, B, STEPS)
    tc = tlm.init_caches(tcfg, B, STEPS, device=CPU)
    for t in range(STEPS):
        want, jc = jserve(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        got, tc = serve(tp, tc, toks[:, t:t + 1])
        assert got.dtype == torch.float32 and tuple(got.shape) == (
            B, jcfg.vocab)
        errs.append(_rel(want, got))
    assert int(tc["pos"]) == STEPS
    return errs


@pytest.mark.parametrize("draw,bound", [("width_scaled", F32_REL),
                                        ("reference", DECODE_REL)])
@pytest.mark.parametrize("case", CASES)
def test_slice_float32_matches_reference(models, case, draw, bound):
    """On matrices at 1/sqrt(input width) within F32_REL, and on the
    reference's own draw (matrices at 1/sqrt(cycles), here 1 or
    1/sqrt(2)) within its 1e-3 for these families.  That draw saturates
    RG-LRU's gates: pre-activations reach hundreds, so float32 inputs
    equal to 2e-7 move r and a by 1e-5, and sqrt(1 - a^2) near a = 1
    takes that to 6e-5 of the block's recurrence input (measured on
    layer 0 of this model: no op of the port differs from the
    reference's beyond float32 rounding)."""
    errs = _slice_errors(models, case, "float32", draw == "width_scaled")
    assert max(errs) < bound, errs


@pytest.mark.parametrize("case", ARCHS)
def test_slice_bf16_matches_reference(models, case):
    """At the reference's ``smoke_config`` depth (RecurrentGemma 3 layers,
    xLSTM 2), where BF16_REL was set: each op of either package rounds to
    8 bits alike, but products sum in another order, and at 5 layers the
    reference's own bf16 logits sit up to 3.1e-2 from its float32 ones
    (the port's 3.6e-2), so that a 5-layer comparison would test that
    noise.  The remainder blocks are held in float32 above."""
    errs = _slice_errors(models, case, "bfloat16", width_scaled=True,
                         smoke_depth=True)
    assert max(errs) < BF16_REL, errs


@pytest.mark.parametrize("arch,dtype", [(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")])
def test_caches_match_reference(models, arch, dtype):
    """Every layer's cache after 8 decode steps, on matrices at 1/sqrt(input
    width): the reference's dtypes (RG-LRU's h and conv in the compute
    dtype, the xLSTM cells' states in float32, attention's k and v in the
    compute dtype) and its values (1e-5 of a leaf's largest |value| in
    float32; in bf16, at the bf16 slice's depth, its bound)."""
    jcfg, tcfg, jp, _, tp = models(arch, dtype, True,
                                   smoke_depth=dtype == "bfloat16")
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab, (B, 8)).astype(np.int32)
    jserve = _jitted(j_serve_step, jcfg)
    serve = tsteps.make_serve_step(tcfg, CPU)
    jc = jlm.init_caches(jcfg, B, 40)
    tc = tlm.init_caches(tcfg, B, 40, device=CPU)
    for t in range(8):
        _, jc = jserve(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        tc = serve(tp, tc, toks[:, t:t + 1])[1]
    tol = 1e-5 if dtype == "float32" else BF16_REL
    jtree = jax.tree.map(np.asarray, jc)
    assert int(tc["pos"]) == int(jtree["pos"]) == 8
    for i, layer in enumerate(tc["layers"]):
        want = _ref_layer(jcfg, jtree, i)
        assert want.keys() == layer.keys(), i
        for part, leaves in want.items():
            for n, a in leaves.items():
                got = layer[part][n]
                assert str(got.dtype).split(".")[1] == a.dtype.name, \
                    (i, part, n, got.dtype, a.dtype)
                assert tuple(got.shape) == a.shape, (i, part, n)
                assert _rel(a.astype(np.float32), got.float()) < tol, \
                    (i, part, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(models, arch):
    """The port's decode logits, a token at a time through the caches,
    against its own cache-less forward over the same tokens (the
    reference's draw, float32)."""
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
        assert float((logits - full[:, t]).abs().max()) / scale < \
            DECODE_REL, t


# -- loss and gradients ----------------------------------------------------------

@pytest.mark.parametrize("arch,chunk", [("recurrentgemma_2b", 16),
                                        ("xlstm_125m", 0)])
def test_lm_loss_and_gradients_match_reference(models, arch, chunk,
                                               monkeypatch):
    """``jax.value_and_grad(lm.lm_loss)`` and the port's loss and gradients
    on matrices at 1/sqrt(input width).  The port runs remat full (each
    layer's recurrence recomputed in the backward), the reference none,
    which compiles in a third of the time; remat moves no value
    (``tests/test_torch_train.py`` holds the modes equal).  xLSTM's mLSTM
    loop runs in checkpointed chunks of 16 tokens (``MLSTM_CHUNK``), three
    over S 48, inside each layer's remat."""
    monkeypatch.setattr(tblocks, "MLSTM_CHUNK", 16)
    jcfg = _cfgs(arch, loss_chunk=chunk, remat="none")[0]
    tcfg = _cfgs(arch, loss_chunk=chunk, remat="full")[1]
    jp = models(arch, width_scaled=True)[2]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
             "mask": rng.random((B, S)) < 0.9}
    jloss, jgrads = jax.jit(jax.value_and_grad(functools.partial(
        jlm.lm_loss, jcfg)))(jp, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), CPU,
                              trainable=True)
    loss = tlm.lm_loss(tcfg, model, {k: torch.as_tensor(v)
                                     for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    got = jax.tree.leaves(to_reference_tree(
        tcfg, {n: p.grad for n, p in model.named_parameters()}))
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(got) == len(want)
    for (path, a), g in zip(want, got):
        a = np.asarray(a, np.float64)
        err = np.abs(a - g.numpy()).max() / max(np.abs(a).max(), 1e-30)
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("chunk", [4, 5])
def test_mlstm_chunks_equal_the_whole_loop(models, monkeypatch, chunk):
    """The mLSTM block with grad on over S 16, its loop in checkpointed
    chunks of 4 tokens (5: the last one short) against the whole loop
    (``MLSTM_CHUNK`` at S): the output and the gradients of the input and
    of every parameter are bitwise equal (each chunk's recompute repeats
    the whole loop's operations on the same values, and the chunks'
    gradients meet only by concatenation).  Without grad the block runs
    the whole loop whatever the chunk."""
    _, tcfg, _, _, tp = models("xlstm_125m", width_scaled=True)
    part = tp.layers[0].cell
    x = _t(np.random.default_rng(9).normal(0, 1, (B, 16, tcfg.d_model)))
    dy = _t(np.random.default_rng(10).normal(0, 1, (B, 16, tcfg.d_model)))
    params = list(part.parameters())
    calls, loop = [], tblocks.mlstm_loop
    monkeypatch.setattr(tblocks, "mlstm_loop",
                        lambda *a: calls.append(a[3].shape[1]) or loop(*a))
    res = {}
    for c in (16, chunk):
        monkeypatch.setattr(tblocks, "MLSTM_CHUNK", c)
        xg = x.clone().requires_grad_()
        for w in params:
            w.requires_grad_()
        calls = []
        y, _ = tblocks.apply_mlstm(tcfg, part, xg)
        grads = torch.autograd.grad(y, [xg] + params, dy)
        for w in params:
            w.requires_grad_(False)
        res[c] = (y.detach(), grads, list(calls))
        with torch.no_grad():
            calls.clear()
            assert torch.equal(tblocks.apply_mlstm(tcfg, part, x)[0],
                               y.detach())
            assert calls == [16]
    (y0, g0, c0), (y1, g1, c1) = res[16], res[chunk]
    assert c0 == [16]
    # the forward's chunks, then each recomputed in the backward
    fwd = [min(chunk, 16 - i) for i in range(0, 16, chunk)]
    assert c1 == fwd + fwd[::-1]
    assert torch.equal(y0, y1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


# -- weights across --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bit_for_bit(models, arch):
    """bf16 weights in and out bit for bit: the ``rec``, ``ffn`` and
    ``cell`` subtrees, RecurrentGemma's remainder blocks after the body."""
    jcfg, tcfg, jp, tree, tp = models(arch, "bfloat16")
    assert len(tree["rem"]) == len(jcfg.remainder_blocks)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back = params_to_numpy(tcfg, tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for (path, a), b in zip(flat, jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a).view(np.uint16), b), \
            jax.tree_util.keystr(path)
    assert sum(a.size for _, a in flat) == tlm.count_params(tp)


# -- full width on meta ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_on_meta(arch):
    """Every parameter's name and shape as the reference's plan (body,
    then remainder), and the count as its ``roofline.model_params``:
    2,894,481,920 and 134,287,104."""
    tcfg, jcfg = TC.get(arch), JC.get(arch)
    model = tlm.init_params(tcfg, torch.Generator(), device="meta")
    n = tlm.count_params(model)
    assert n == jroofline.model_params(jcfg) == \
        {"recurrentgemma_2b": 2_894_481_920, "xlstm_125m": 134_287_104}[arch]
    got = {nm: tuple(p.shape) for nm, p in model.named_parameters()}
    want = {}
    width = len(jcfg.block_pattern)
    plan = jax.tree_util.tree_flatten_with_path(
        jlm.plan_model(jcfg),
        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]
    for path, spec in plan:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[0] == "body":
            k = int(keys[1][1:keys[1].index("_")])
            for c in range(jcfg.cycles):
                want[f"layers.{c * width + k}.{keys[2]}.{keys[3]}"] = \
                    tuple(spec.shape[1:])
        elif keys[0] == "rem":
            want[f"layers.{jcfg.cycles * width + keys[1]}.{keys[2]}."
                 f"{keys[3]}"] = tuple(spec.shape)
        else:
            want[".".join(map(str, keys))] = tuple(spec.shape)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_long_500k_caches(arch):
    """long_500k's decode (1 x 524,288): a local layer holds at most its
    window of 2,048 slots, a recurrent layer a state of fixed size."""
    cfg = TC.get(arch)
    caches = tlm.init_caches(cfg, 1, 524288, device="meta")
    kinds = cfg.layer_kinds
    assert len(caches["layers"]) == len(kinds)
    for kind, layer in zip(kinds, caches["layers"]):
        if kind == "attn_local":
            assert tuple(layer["attn"]["k"].shape) == (1, 2048, 1, 256)
        else:
            assert "attn" not in layer
    def elements(max_len):
        c = tlm.init_caches(cfg, 1, max_len, device="meta")
        return sum(t.numel() for layer in c["layers"]
                   for part in layer.values() for t in part.values())
    # past the window, the length changes nothing
    assert elements(524288) == elements(2048)
