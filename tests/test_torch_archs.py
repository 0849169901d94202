"""The attention-only archs beyond Gemma 2 and Qwen3 against the JAX
package, on the CPU: Mistral NeMo 12B, Chameleon 34B (qk-norm), StableLM
12B (hd 160) and HuBERT X-Large (an encoder: frame embeddings in, not
causal, a GELU FFN, no decode).

The same inputs, made with numpy from a seed, go through ``repro`` (the
reference) and ``repro_torch``; the port's weights are the reference's,
carried across by ``params_from_numpy``.  Smoke width is the reference's
``smoke_config`` (hd 16); StableLM and HuBERT also run at their true head
dims, 160 and 80 (``smoke_config(cfg).replace(head_dim=cfg.head_dim)``),
so that the flash wrapper's plain version runs there.  On CPU tensors the
wrapper takes its plain version; the kernel itself is held against that
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Bounds, as ``tests/test_torch_models.py`` and ``tests/test_torch_train.py``
state them: blocks within 1e-5 of the largest |output|; the slice
(prefill, 48 decode steps, HuBERT's logits at every position) within 2e-4
of the largest |logit| in float32 and 3e-2 in bf16 on body matrices at
1/sqrt(input width); the loss within 1e-5 and every gradient leaf within
1e-4 of its largest |value|; weights bit for bit.
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
from repro.launch import train as jtrain
from repro.launch.steps import make_prefill_step as j_prefill_step
from repro.launch.steps import make_serve_step as j_serve_step
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models.config import smoke_config as j_smoke

import repro_torch.configs as TC
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.models.config import smoke_config as t_smoke
from repro_torch.models.transfer import (
    params_from_numpy, params_to_numpy, to_reference_tree,
)

CPU = "cpu"
NEW = ("mistral_nemo_12b", "chameleon_34b", "stablelm_12b", "hubert_xlarge")
# "arch" at smoke width, "arch@hd" at smoke width with the true head dim
CASES = ("mistral_nemo_12b", "chameleon_34b", "stablelm_12b",
         "stablelm_12b@160", "hubert_xlarge", "hubert_xlarge@80")
F32_REL = 2e-4
BF16_REL = 3e-2
STEPS = 48
B, S = 2, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: without this, 6 pytest-xdist workers on 8
    cores slow them several-fold by intra-op fan-out."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _cfgs(case, dtype="float32", **kw):
    arch, _, hd = case.partition("@")
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **kw)
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


def _width_scaled(jp):
    """Every body matrix at 1/sqrt(its input width), as
    ``chip_smoke.parity_model`` draws them (see test_torch_models)."""
    def rescale(path, a):
        if a.ndim < 3:
            return a
        width = a.shape[1] * a.shape[2] if path[-1].key == "wo" \
            else a.shape[1]
        return (a.astype(jnp.float32) / np.sqrt(width)).astype(a.dtype)
    return {**jp, "body": jax.tree_util.tree_map_with_path(rescale,
                                                           jp["body"])}


def _inputs(jcfg, rng):
    """Token ids [B, S], or frame embeddings [B, S, d] for HuBERT."""
    if jcfg.embed_inputs:
        return rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return rng.normal(0, 1, (B, S, jcfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(case, dtype="float32", width_scaled=False):
        key = case, dtype, width_scaled
        if key not in cache:
            jcfg, tcfg = _cfgs(case, dtype)
            jp = jlm.init_params(jcfg, jax.random.PRNGKey(3))
            if width_scaled:
                jp = _width_scaled(jp)
            tree = jax.tree.map(np.asarray, jp)
            cache[key] = (jcfg, tcfg, jp, tree,
                          params_from_numpy(tcfg, tree, device=CPU))
        return cache[key]
    return get


# -- configs and cells ---------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference(arch):
    t, j = TC.get(arch), JC.get(arch)
    for f in ModelConfig.__dataclass_fields__:
        want = getattr(j, f)
        if dataclasses.is_dataclass(want):       # sharding: by value
            assert dataclasses.asdict(getattr(t, f)) == \
                dataclasses.asdict(want), (arch, f)
        else:
            assert getattr(t, f) == want, (arch, f)
    assert TC.get(arch.replace("_", "-")) is t
    assert [c.name for c in TC.shape_cells(t)] == \
        [c.name for c in JC.shape_cells(j)]


def test_cells_match_reference():
    want = JC.all_cells()
    assert TC.all_cells() == want
    assert {a for a, _ in want} == set(TC.PORTED) == set(TC.ARCHS)
    assert ("hubert_xlarge", "decode_32k") not in want
    for arch in ("deepseek_v3_671b", "llama4_scout_17b_a16e"):
        assert [c for c in TC.all_cells() if c[0] == arch] == \
            [c for c in want if c[0] == arch] == \
            [(arch, n) for n in ("train_4k", "prefill_32k", "decode_32k")]


# -- blocks --------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_blocks_match_reference(models, case):
    jcfg, tcfg, jp, _, tp = models(case)
    jblk = jax.tree.map(lambda a: a[0], jp["body"]["b0_attn_dense"])
    layer = tp.layers[0]
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 40, jcfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(40, dtype=jnp.int32)[None], (2, 40))
    want, _ = jblocks.apply_attention(jcfg, jblk["attn"], jnp.asarray(x),
                                      pos)
    got, _ = tblocks.apply_attention(tcfg, layer.attn, _t(x))
    assert _rel(want, got) < 1e-5
    want = jblocks.apply_ffn(jcfg, jblk["ffn"], jnp.asarray(x),
                             kind=jcfg.ffn_kind)
    got = tblocks.apply_ffn(tcfg, layer.ffn, _t(x), kind=tcfg.ffn_kind)
    assert _rel(want, got) < 1e-5


def test_gelu_matches_reference():
    """HuBERT's FFN activation: the tanh approximation on both sides."""
    h = np.random.default_rng(5).normal(0, 3, (4, 64)).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(_t(h), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(h), approximate=True)),
        rtol=1e-6, atol=1e-6)


# -- the slice: prefill and decode; HuBERT's forward ----------------------------

def _slice_errors(models, case, dtype, width_scaled=False):
    jcfg, tcfg, jp, _, tp = models(case, dtype, width_scaled)
    rng = np.random.default_rng(4)
    inputs = _inputs(jcfg, rng)
    want = jax.jit(j_prefill_step(jcfg))(jp, {"inputs": jnp.asarray(inputs)})
    got = tsteps.make_prefill_step(tcfg, CPU)(tp, {"inputs": inputs})
    assert tuple(got.shape) == (B, 1, jcfg.vocab)
    assert got.dtype == tcfg.dtype("compute")
    errs = [_rel(want, got.float())]
    if not jcfg.causal:
        # every position's logits: a causal mask would move them all but
        # the last
        def jfull(p, x):
            h, _ = jlm.forward(jcfg, p, x, jnp.broadcast_to(
                jnp.arange(S, dtype=jnp.int32)[None], (B, S)))
            return jlm.logits_fn(jcfg, p, h)
        want = jax.jit(jfull)(jp, jnp.asarray(inputs))
        with torch.no_grad():
            h, _ = tlm.forward(tcfg, tp, torch.from_numpy(inputs))
            got = tlm.logits_fn(tcfg, tp, h)
        errs.append(_rel(want, got.float()))
        with torch.no_grad():
            h, _ = tlm.forward(tcfg.replace(causal=True), tp,
                               torch.from_numpy(inputs))
            causal = tlm.logits_fn(tcfg, tp, h)
        assert _rel(want, causal.float()) > 10 * BF16_REL
        return errs
    jserve = jax.jit(j_serve_step(jcfg))
    serve = tsteps.make_serve_step(tcfg, CPU)
    jc = jlm.init_caches(jcfg, B, STEPS)
    tc = tlm.init_caches(tcfg, B, STEPS, device=CPU)
    for t in range(STEPS):
        want, jc = jserve(jp, jc, jnp.asarray(inputs[:, t:t + 1]))
        got, tc = serve(tp, tc, inputs[:, t:t + 1])
        assert got.dtype == torch.float32 and tuple(got.shape) == (
            B, jcfg.vocab)
        errs.append(_rel(want, got))
    assert int(tc["pos"]) == STEPS
    return errs


@pytest.mark.parametrize("case", CASES)
def test_slice_float32_matches_reference(models, case):
    errs = _slice_errors(models, case, "float32")
    assert max(errs) < F32_REL, errs


@pytest.mark.parametrize("case", CASES)
def test_slice_bf16_matches_reference(models, case):
    errs = _slice_errors(models, case, "bfloat16", width_scaled=True)
    assert max(errs) < BF16_REL, errs


def test_encoder_has_no_decode(models):
    _, tcfg, _, _, tp = models("hubert_xlarge")
    with pytest.raises(ValueError, match="shape_cells"):
        tlm.init_caches(tcfg, 1, 8, device=CPU)
    with pytest.raises(ValueError, match="not causal"):
        tsteps.make_serve_step(tcfg, CPU)(tp, {}, np.zeros((1, 1, 64)))
    assert "embed" not in dict(tp.named_parameters())
    assert tp.device == torch.device(CPU)


def test_steps_refuse_inputs_of_the_other_kind(models):
    _, hcfg, _, _, hp = models("hubert_xlarge")
    _, mcfg, _, _, mp = models("mistral_nemo_12b")
    with pytest.raises(ValueError, match=r"embeddings \[B, S, 64\]"):
        tsteps.make_prefill_step(hcfg, CPU)(
            hp, {"inputs": np.zeros((1, 8), np.int32)})
    with pytest.raises(ValueError, match=r"token ids \[B, S\]"):
        tsteps.make_prefill_step(mcfg, CPU)(
            mp, {"inputs": np.zeros((1, 8, 64), np.float32)})


# -- loss and gradients ----------------------------------------------------------

@pytest.mark.parametrize("case,chunk", [("hubert_xlarge@80", 0),
                                        ("stablelm_12b@160", 16)])
def test_lm_loss_and_gradients_match_reference(case, chunk):
    """``jax.value_and_grad(lm.lm_loss)`` and the port's loss and
    gradients (remat full, the flash plain version in the forward, the
    dense formula's autograd behind it), on body matrices at 1/sqrt(input
    width).  On the reference's own draw (1/sqrt(cycles)) both float32
    sides sit about 1e-4 of a leaf from a float64 run of the port (the
    attention norm's gradient at hd 160: the reference 1.4e-4, the port
    1.2e-4), rounding amplified by a draw that saturates the softmax; on
    this draw both sit under 1e-6 of it."""
    jcfg, tcfg = _cfgs(case, loss_chunk=chunk, remat="full")
    jp = _width_scaled(jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"inputs": toks[:, :-1] if jcfg.embed_inputs
             else _inputs(jcfg, rng), "targets": toks[:, 1:],
             "mask": rng.random((B, S)) < (0.9 if jcfg.causal else 0.3)}
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


# -- weights across --------------------------------------------------------------

@pytest.mark.parametrize("case", ["hubert_xlarge", "chameleon_34b"])
def test_params_from_numpy_bit_for_bit(models, case):
    """bf16 weights in and out bit for bit, HuBERT's tree without
    ``embed`` (with ``head``) and Chameleon's with qk-norm scales."""
    jcfg, tcfg, jp, tree, tp = models(case, "bfloat16")
    assert ("embed" in tree) == jcfg.embed_inputs
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back = params_to_numpy(tcfg, tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for (path, a), b in zip(flat, jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a).view(np.uint16), b), \
            jax.tree_util.keystr(path)
    assert sum(a.size for _, a in flat) == tlm.count_params(tp)


# -- the trainer's frontend stub ---------------------------------------------------

def test_trainer_stub_inputs_equal_reference(monkeypatch, tmp_path):
    """HuBERT's trainer feeds each step the reference's stub embeddings
    (``table[ids % 256]``) bit for bit, beside its targets and mask."""
    seen = {"ref": [], "port": []}

    def recorder(which, loss):
        def make(cfg, opt_cfg=None, device=None):
            def step(params, opt, batch):
                seen[which].append({k: np.asarray(v) for k, v in
                                    batch.items()})
                return params, opt, {"loss": loss}
            return step
        return make

    jcfg = jtrain.preset_config(JC.get("hubert_xlarge"), "smoke")
    tcfg = ttrain.preset_config(TC.get("hubert_xlarge"), "smoke")
    run = dict(steps=2, global_batch=2, seq_len=16, ckpt_every=100)
    monkeypatch.setattr(jtrain, "make_train_step",
                        recorder("ref", jnp.float32(0)))
    monkeypatch.setattr(jtrain.jax, "jit", lambda f, **kw: f)
    jtrain.train(jcfg, out=str(tmp_path / "ref"), **run)
    monkeypatch.setattr(ttrain, "make_train_step",
                        recorder("port", torch.zeros(())))
    ttrain.train(tcfg, out=str(tmp_path / "port"), device=CPU, **run)
    assert len(seen["ref"]) == len(seen["port"]) == 2
    for want, got in zip(seen["ref"], seen["port"]):
        assert want.keys() == got.keys()
        assert got["inputs"].shape == (2, 16, tcfg.d_model)
        assert got["inputs"].dtype == np.float32
        for k in want:
            assert np.array_equal(want[k], got[k]), k
        assert 0 < got["mask"].mean() < 0.6     # masked-frame prediction


def test_hubert_trajectory_matches_reference(tmp_path):
    """Two steps of HuBERT smoke (float32) through both trainers from the
    same weights (a step-0 checkpoint of the reference's)."""
    from repro.ckpt import save_pytree as j_save
    from repro.optim import adamw as jadamw
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = jtrain.preset_config(JC.get("hubert_xlarge"), "smoke").replace(
        **f32)
    tcfg = ttrain.preset_config(TC.get("hubert_xlarge"), "smoke").replace(
        **f32)
    run = dict(steps=2, global_batch=2, seq_len=32, lr=1e-3, log_every=1,
               ckpt_every=100)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    opt = jadamw.adamw_init(jp, jadamw.AdamWConfig(lr=run["lr"],
                                                   total_steps=2))
    for name in ("ref", "port"):
        j_save(str(tmp_path / name), 0, {"params": jp, "opt": opt})
    want = jtrain.train(jcfg, out=str(tmp_path / "ref"), **run)
    got = ttrain.train(tcfg, out=str(tmp_path / "port"), device=CPU, **run)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- full width on meta ------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_full_width_on_meta(arch):
    """Every parameter's name and shape as the reference's plan, and the
    count as its ``roofline.model_params``."""
    tcfg, jcfg = TC.get(arch), JC.get(arch)
    model = tlm.init_params(tcfg, torch.Generator(), device="meta")
    assert tlm.count_params(model) == jroofline.model_params(jcfg)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {}
    plan = jax.tree_util.tree_flatten_with_path(
        jlm.plan_model(jcfg),
        is_leaf=lambda x: isinstance(x, jcommon.ParamSpec))[0]
    for path, spec in plan:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[0] == "body":
            for c in range(jcfg.cycles):
                want[f"layers.{c}.{keys[2]}.{keys[3]}"] = \
                    tuple(spec.shape[1:])
        else:
            want[".".join(map(str, keys))] = tuple(spec.shape)
    assert got == want


# -- the flash wrapper's head dims ------------------------------------------------

def test_flash_refuses_head_dims_without_a_kernel():
    """A pair of head dims that no kernel takes (96, or the smoke MLA's
    (24, 16)) has none for a CUDA tensor (``kernel_for`` is None), and a
    tensor off the CPU is refused there before any launch (on ``meta``
    here); MLA's (192, 128) has one on both routes.  CPU tensors take the
    plain version at any pair: [B, H, S, vd] out."""
    from repro_torch.kernels.flash_attention import flash_attention, kernel_for
    for dtype, route in ((torch.bfloat16, "wgmma"), (torch.float32, "f32")):
        assert kernel_for(96, 96, dtype) is None
        assert kernel_for(24, 16, dtype) is None
        assert kernel_for(192, 128, dtype) == route
        assert kernel_for(128, 128, dtype) == route
    q = torch.zeros((1, 2, 8, 96), device="meta")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    for hd, vd in ((192, 128), (24, 16), (96, 96)):
        q, v = torch.zeros((1, 2, 8, hd)), torch.ones((1, 2, 8, vd))
        out = flash_attention(q, q, v)
        assert tuple(out.shape) == (1, 2, 8, vd) and bool((out == 1).all())
