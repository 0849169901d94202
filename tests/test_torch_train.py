"""The port's LM training slice against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through ``repro`` (the
reference, ``jax.jit`` on the CPU, attention through XLA) and
``repro_torch`` (the flash wrapper's plain version on CPU tensors, the
gradient through ``blocks.FlashAttend``'s dense recompute); weights cross
over with ``params_from_numpy`` and back with ``to_reference_tree``.
Everything is float32 unless a test says otherwise.

Tolerances: the loss within 1e-5 and every gradient leaf within 1e-4 of
its leaf's largest |value| (measured on the CPU: 1e-6 and 2e-6);
train steps and trajectories within 1e-5 (sums taken in other orders).
Gemma 2 runs on body matrices at 1/sqrt(input width), as
``test_torch_models._width_scaled`` explains: the reference's own draw
saturates the softcaps at smoke width and leaves rounding-only gaps near
1e-4 of a gradient leaf.
"""
import functools
import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

import repro.configs as JC
from repro.ckpt import CheckpointManager as JManager
from repro.ckpt import restore_pytree as j_restore
from repro.ckpt import save_pytree as j_save
from repro.data import pipeline as jdata
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.models.config import smoke_config as j_smoke
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress

import repro_torch.configs as TC
from repro_torch.ckpt import CheckpointManager as TManager
from repro_torch.ckpt import restore_pytree as t_restore
from repro_torch.data import pipeline as tdata
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.config import smoke_config as t_smoke
from repro_torch.models.transfer import (
    numpy_of, opt_state_from_numpy, opt_state_to_numpy, params_from_numpy,
    params_to_numpy, to_reference_tree,
)
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress

CPU = "cpu"
F32 = dict(param_dtype="float32", compute_dtype="float32")
B, S, CHUNK = 2, 64, 16
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: without this, 6 pytest-xdist workers on 8
    cores slow them several-fold by intra-op fan-out."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _cfgs(arch, **kw):
    kw = {**F32, **kw}
    return (j_smoke(JC.get(arch)).replace(**kw),
            t_smoke(TC.get(arch)).replace(**kw))


def _width_scaled(jp):
    def rescale(path, a):
        if a.ndim < 3:
            return a
        width = a.shape[1] * a.shape[2] if path[-1].key == "wo" \
            else a.shape[1]
        return a / np.sqrt(width)
    return jax.tree_util.tree_map_with_path(rescale, jp)


def _ref_params(jcfg, arch):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return _width_scaled(jp) if arch == "gemma2_9b" else jp


def _batch(vocab, rng, b=B, s=S):
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:],
            "mask": rng.random((b, s)) < 0.9}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _leaf_rel(want_tree, got_tree):
    """Largest |got - want| over the largest |want| of each leaf, both
    trees in the reference's layout."""
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = jax.tree.leaves(got_tree)
    assert len(want) == len(got)
    return {jax.tree_util.keystr(p): float(
        np.abs(np.asarray(a, np.float64) - np.asarray(g, np.float64)).max()
        / max(np.abs(np.asarray(a)).max(), 1e-30))
        for (p, a), g in zip(want, got)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 200), (0, 50), (100, 400)])
def test_cosine_schedule_matches_reference(warmup, total):
    """Bitwise at every step where the cosine's argument is 0 (the warm-up
    and step == warmup); elsewhere within lr * 2^-23, two float32 steps of
    the cosine: XLA and PyTorch evaluate cos with other polynomials (the
    reference's own jitted and eager values differ by more)."""
    jcfg = jadamw.AdamWConfig(warmup=warmup, total_steps=total)
    tcfg = tadamw.AdamWConfig(warmup=warmup, total_steps=total)
    want = np.array([np.asarray(jadamw.cosine_schedule(jcfg, jnp.int32(s)))
                     for s in range(total + 1)], np.float32)
    got = np.array([tadamw.cosine_schedule(tcfg, s).numpy()
                    for s in range(total + 1)], np.float32)
    assert got.dtype == want.dtype
    flat = np.arange(total + 1) <= warmup
    np.testing.assert_array_equal(got[flat], want[flat])
    assert got[warmup] == want[warmup]
    assert np.abs(got - want).max() <= jcfg.lr * 2.0**-23


def _opt_case(rng, dtype):
    shapes = {"w": (16, 8), "b": (8,), "e": (32, 4)}
    params = {n: rng.normal(0, 1, s).astype(np.float32)
              for n, s in shapes.items()}
    if dtype == "bfloat16":
        params = {n: a.astype(ml_dtypes.bfloat16) for n, a in params.items()}
    grads = [{n: rng.normal(0, 0.5, s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(4)]
    return params, grads


def _tparams(params):
    return {n: numpy_to_tensor(a) for n, a in params.items()}


def numpy_to_tensor(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


OPT = dict(lr=1e-2, warmup=2, total_steps=10, weight_decay=0.1,
           clip_norm=1.0)


def test_adamw_update_matches_reference_float32():
    """4 steps (the gradients' norm ~8 > clip_norm 1: the clip acts):
    params and moments within 1e-6 of each leaf's largest value."""
    rng = np.random.default_rng(0)
    params, grads = _opt_case(rng, "float32")
    jcfg, tcfg = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jo = jadamw.adamw_init(jp, jcfg)
    tp = _tparams(params)
    to = tadamw.adamw_init(tp, tcfg)
    for g in grads:
        jp, jo, jinfo = jadamw.adamw_update(
            {n: jnp.asarray(a) for n, a in g.items()}, jo, jp, jcfg)
        tp, to, tinfo = tadamw.adamw_update(
            {n: torch.from_numpy(a) for n, a in g.items()}, to, tp, tcfg)
        for w, want, got in (("p", jp, tp), ("m", jo["m"], to["m"]),
                             ("v", jo["v"], to["v"])):
            for n in want:
                a = np.asarray(want[n])
                assert np.abs(a - got[n].numpy()).max() \
                    <= 1e-6 * np.abs(a).max(), (w, n)
        assert int(to["step"]) == int(jo["step"])
        assert to["step"].dtype == torch.int32
        assert abs(float(tinfo["lr"]) - float(jinfo["lr"])) <= 1e-12
        assert abs(float(tinfo["grad_norm"]) - float(jinfo["grad_norm"])) \
            <= 1e-6 * float(jinfo["grad_norm"])
        assert float(jinfo["grad_norm"]) > OPT["clip_norm"]


def test_adamw_update_bf16_params_bit_for_bit():
    """bf16 params: each step, from the same params and state, the cast
    results agree bit for bit except where the float32 value before the
    cast lies within 1e-6 of it from a rounding midpoint (there the two
    float32 intermediates may round either way)."""
    rng = np.random.default_rng(1)
    params, grads = _opt_case(rng, "bfloat16")
    jcfg, tcfg = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jo = jadamw.adamw_init(jp, jcfg)
    checked = 0
    for g in grads:
        tp = _tparams(_np(jp))
        to = {"m": _tparams(_np(jo["m"])), "v": _tparams(_np(jo["v"])),
              "step": torch.tensor(int(jo["step"]), dtype=torch.int32)}
        f32 = {n: t.float() for n, t in tp.items()}     # exact upcast
        f32_state = {"m": {n: t.clone() for n, t in to["m"].items()},
                     "v": {n: t.clone() for n, t in to["v"].items()},
                     "step": to["step"].clone()}
        tg = {n: torch.from_numpy(a) for n, a in g.items()}
        tadamw.adamw_update(tg, f32_state, f32, tcfg)
        tadamw.adamw_update(tg, to, tp, tcfg)
        jp, jo, _ = jadamw.adamw_update(
            {n: jnp.asarray(a) for n, a in g.items()}, jo, jp, jcfg)
        for n in jp:
            want = np.asarray(jp[n]).view(np.uint16)
            got = numpy_of(tp[n])
            pre = f32[n].numpy()
            lo = np.asarray(jp[n]).astype(np.float32)
            bad = want != got
            if bad.any():
                # the midpoint between the two bf16 values either side
                other = got[bad].view(ml_dtypes.bfloat16).astype(np.float32)
                mid = (lo[bad] + other) / 2
                assert np.all(np.abs(pre[bad] - mid)
                              <= 1e-6 * np.abs(pre[bad])), n
            checked += want.size
            np.testing.assert_allclose(to["m"][n].numpy(),
                                       np.asarray(jo["m"][n]), rtol=0,
                                       atol=1e-6 * np.abs(jo["m"][n]).max())
    assert checked > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_in_slices_is_bitwise_whole(monkeypatch, dtype):
    """With ``ADAMW_SLICE_ELEMS`` at 20, the two leaves of 128 elements
    are updated in slices of their leading axis ([16, 8] in 8 slices of 2
    rows, [32, 4] in 7 of 5 rows, the last short), the 8-element one
    whole: 4 steps give parameters and moments bitwise equal to the
    whole-leaf update's.  Llama 4 Scout's expert leaf at the default goes
    in 3 slices of at most 6 of its 16 experts."""
    assert [(sl.start, sl.stop) for sl in tadamw.leaf_slices(
        (16, 5120, 16384))] == [(0, 6), (6, 12), (12, 18)]
    assert tadamw.leaf_slices((8,)) == [...]
    rng = np.random.default_rng(2)
    params, grads = _opt_case(rng, dtype)
    tcfg = tadamw.AdamWConfig(**OPT)
    runs = []
    for elems in (tadamw.ADAMW_SLICE_ELEMS, 20):
        monkeypatch.setattr(tadamw, "ADAMW_SLICE_ELEMS", elems)
        assert len(tadamw.leaf_slices((16, 8))) == (1 if elems > 128
                                                    else 8)
        tp = _tparams(params)
        to = tadamw.adamw_init(tp, tcfg)
        for g in grads:
            tp, to, _ = tadamw.adamw_update(
                {n: torch.from_numpy(a) for n, a in g.items()}, to, tp, tcfg)
        runs.append((tp, to))
    (wp, wo), (sp, so) = runs
    for n in wp:
        assert torch.equal(wp[n], sp[n]) and torch.equal(wo["m"][n],
                                                         so["m"][n]) \
            and torch.equal(wo["v"][n], so["v"][n]), n
    assert len(tadamw.leaf_slices((32, 4))) == 7


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(0, 1, (64, 3)).astype(np.float32),
            "b": rng.normal(0, 1e3, (7,)).astype(np.float32)}
    want = float(jadamw.global_norm({n: jnp.asarray(a)
                                     for n, a in tree.items()}))
    got = float(tadamw.global_norm(_tparams(tree)))
    assert abs(got - want) <= 1e-6 * want
    assert float(tadamw.global_norm({"a": torch.tensor([3.0]),
                                     "b": torch.tensor([4.0])})) == 5.0
    # a huge gradient: the clip keeps the step bounded, as the reference's
    cfg = dict(lr=1e-2, warmup=0, total_steps=100, weight_decay=0.0)
    params = {"w": np.ones((4, 4), np.float32), "b": np.zeros(4, np.float32)}
    g = {"w": np.full((4, 4), 1e6, np.float32), "b": np.zeros(4, np.float32)}
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jp2, _, jinfo = jadamw.adamw_update(
        {n: jnp.asarray(a) for n, a in g.items()},
        jadamw.adamw_init(jp, jadamw.AdamWConfig(**cfg)), jp,
        jadamw.AdamWConfig(**cfg))
    tp = _tparams(params)
    tp2, _, tinfo = tadamw.adamw_update(
        _tparams(g), tadamw.adamw_init(tp, tadamw.AdamWConfig(**cfg)), tp,
        tadamw.AdamWConfig(**cfg))
    assert float(tinfo["grad_norm"]) > 1e6
    assert np.abs(tp2["w"].numpy() - 1.0).max() < 0.1
    for n in jp2:
        np.testing.assert_allclose(tp2[n].numpy(), np.asarray(jp2[n]),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# compress
# ---------------------------------------------------------------------------

def test_quantize_and_wire_bytes_match_reference():
    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 10.0):
        x = rng.normal(0, scale, 257).astype(np.float32)
        jq, js = jcompress.quantize_int8(jnp.asarray(x))
        tq, ts = tcompress.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tq.dtype == torch.int8 and float(ts) == float(js)
        np.testing.assert_array_equal(
            tcompress.dequantize_int8(tq, ts).numpy(),
            np.asarray(jcompress.dequantize_int8(jq, js)))
    grads = {"a": np.zeros((100, 100), np.float32), "b": np.zeros(77)}
    assert tcompress.wire_bytes({n: torch.from_numpy(a)
                                 for n, a in grads.items()}) \
        == jcompress.wire_bytes({n: jnp.asarray(a) for n, a in grads.items()})
    buf = tcompress.init_error_buffers({"a": torch.zeros(3, 2)})
    assert buf["a"].dtype == torch.bfloat16 and buf["a"].shape == (3, 2)


_PSUM_SCRIPT = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.optim.compress import compressed_tree_psum

mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
z = np.load(sys.argv[1])
g = {"w": jnp.asarray(z["w"]), "b": jnp.asarray(z["b"])}
err = {"w": jnp.asarray(z["ew"]).astype(jnp.bfloat16),
       "b": jnp.asarray(z["eb"]).astype(jnp.bfloat16)}

def f(gl, el):
    gl = jax.tree.map(lambda a: a[0], gl)
    el = jax.tree.map(lambda a: a[0], el)
    rg, re = compressed_tree_psum(gl, "data", el)
    return (jax.tree.map(lambda a: a[None], rg),
            jax.tree.map(lambda a: a[None], re))

fm = shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
               out_specs=(P("data"), P("data")), check_rep=False)
rg, re = jax.jit(fm)(g, err)
np.savez(sys.argv[2], w=np.asarray(rg["w"]), b=np.asarray(rg["b"]),
         ew=np.asarray(re["w"].astype(jnp.float32)),
         eb=np.asarray(re["b"].astype(jnp.float32)))
"""


def test_compressed_tree_psum_matches_reference_shard_map(tmp_path):
    """The reference's ``shard_map`` over 8 host devices (a subprocess, as
    tests/test_compress.py) against the port's [8, ...] stack: the error
    buffers within one bf16 step (2^-7 of the value) plus one float32
    rounding of the largest |x + err| (XLA may fuse the dequantize and the
    subtraction into one FMA, which rounds once: it keeps residuals of
    1e-7 where two roundings leave 0, and moves others across a bf16
    rounding boundary), the mean within 1e-6 of its largest value (8
    terms summed in another order)."""
    rng = np.random.default_rng(4)
    inp = {"w": rng.normal(0, 1, (8, 16, 4)).astype(np.float32),
           "b": rng.normal(0, 1, (8, 5)).astype(np.float32),
           "ew": rng.normal(0, 1e-2, (8, 16, 4)).astype(ml_dtypes.bfloat16)
           .astype(np.float32),
           "eb": rng.normal(0, 1e-2, (8, 5)).astype(ml_dtypes.bfloat16)
           .astype(np.float32)}
    np.savez(tmp_path / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _PSUM_SCRIPT,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    want = np.load(tmp_path / "out.npz")
    g = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
    err = {"w": torch.from_numpy(inp["ew"]).bfloat16(),
           "b": torch.from_numpy(inp["eb"]).bfloat16()}
    rg, re = tcompress.compressed_tree_psum(g, err)
    for n in ("w", "b"):
        assert rg[n].shape == g[n].shape and rg[n].dtype == torch.float32
        np.testing.assert_allclose(rg[n].numpy(), want[n], rtol=0,
                                   atol=1e-6 * np.abs(want[n]).max())
        assert re[n].dtype == torch.bfloat16
        xe = np.abs(inp[n] + inp["e" + n]).max()
        assert np.all(np.abs(re[n].float().numpy() - want["e" + n])
                      <= 2.0**-7 * np.abs(want["e" + n]) + 2.0**-23 * xe)
    mean = {n: inp[n].mean(axis=0) for n in ("w", "b")}
    for n in mean:                     # the int8 single-round error bound
        assert np.abs(rg[n][3].numpy() - mean[n]).max() \
            < 0.05 * np.abs(mean[n]).max()


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

CASES = {
    "qwen3": ("qwen3_1_7b", 0, False),
    "qwen3-mtp-chunked": ("qwen3_1_7b", CHUNK, True),
    "gemma2": ("gemma2_9b", 0, False),
    "gemma2-chunked": ("gemma2_9b", CHUNK, False),   # with logit softcap 30
}


@pytest.fixture(scope="module")
def ref_grads():
    """Per case: the configs, the reference's weights (numpy), the batch,
    and ``jax.value_and_grad(lm.lm_loss)``'s loss and gradients."""
    out = {}
    for case, (arch, chunk, mtp) in CASES.items():
        jcfg, tcfg = _cfgs(arch, loss_chunk=chunk, mtp=mtp)
        jp = _ref_params(jcfg, arch)
        batch = _batch(jcfg.vocab, np.random.default_rng(5))
        loss, grads = jax.jit(jax.value_and_grad(functools.partial(
            jlm.lm_loss, jcfg)))(jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        out[case] = (tcfg, _np(jp), batch, float(loss), _np(grads))
    return out


def _port_grads(tcfg, jp, batch, remat):
    cfg = tcfg.replace(remat=remat)
    model = params_from_numpy(cfg, jp, CPU, trainable=True)
    loss = tlm.lm_loss(cfg, model, _tb(batch))
    loss.backward()
    return float(loss), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("case", list(CASES))
def test_lm_loss_and_gradients_match_reference(ref_grads, case, remat):
    tcfg, jp, batch, jloss, jgrads = ref_grads[case]
    loss, grads = _port_grads(tcfg, jp, batch, remat)
    assert abs(loss - jloss) <= 1e-5
    rel = _leaf_rel(jgrads, to_reference_tree(tcfg, grads))
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 1e-4, (worst, rel[worst])


@pytest.mark.parametrize("case", ["qwen3-mtp-chunked", "gemma2"])
def test_remat_modes_give_equal_gradients(ref_grads, case):
    tcfg, jp, batch, _, _ = ref_grads[case]
    base_loss, base = _port_grads(tcfg, jp, batch, "none")
    for remat in ("full", "dots"):
        loss, grads = _port_grads(tcfg, jp, batch, remat)
        assert loss == base_loss
        for n in base:
            assert torch.equal(grads[n], base[n]), (remat, n)


def test_chunked_loss_equals_unchunked(ref_grads):
    tcfg, jp, batch, _, _ = ref_grads["qwen3"]
    model = params_from_numpy(tcfg, jp, CPU)
    with torch.no_grad():
        whole = tlm.lm_loss(tcfg, model, _tb(batch))
        chunked = tlm.lm_loss(tcfg.replace(loss_chunk=CHUNK), model,
                              _tb(batch))
        other = tlm.lm_loss(tcfg.replace(loss_chunk=S), model, _tb(batch))
    assert abs(float(whole) - float(chunked)) <= 1e-5
    assert float(other) == float(whole)     # chunk == S: unchunked
    with pytest.raises(ValueError, match="0..S-1"):
        tlm.lm_loss(tcfg, model, {**_tb(batch), "pos": torch.ones(B, S)})


def test_attention_gradient_is_the_dense_formulas(ref_grads):
    """FlashAttend's q, k, v gradients equal autograd through ``_attend``
    run whole (the recompute in kv-head groups changes nothing), with a
    window and the softcap."""
    from repro_torch.models import blocks
    tcfg = ref_grads["gemma2"][0]
    rng = np.random.default_rng(6)
    b, s, h, kh, hd = 2, 48, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.normal(0, 3, (b, s, n, hd))
                                .astype(np.float32)).requires_grad_()
               for n in (h, kh, kh))
    dout = torch.from_numpy(rng.normal(0, 1, (b, s, h, hd))
                            .astype(np.float32))
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    for window in (0, 16):
        want = torch.autograd.grad(
            blocks._attend(tcfg, q, k, v, pos, pos, window), (q, k, v), dout)
        old = blocks.ATTN_BWD_SCORE_BYTES
        try:
            blocks.ATTN_BWD_SCORE_BYTES = 1     # one kv head a group
            got = torch.autograd.grad(blocks.attend(tcfg, q, k, v, window),
                                      (q, k, v), dout)
        finally:
            blocks.ATTN_BWD_SCORE_BYTES = old
        for w, g in zip(want, got):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# train step, eval step, trainer
# ---------------------------------------------------------------------------

# the reference's default lr, at full strength from step 1: AdamW divides
# by sqrt(v), so where a gradient element is near eps a float32 gap in it
# moves that element's step by a fraction of lr (at lr 1e-3 the largest
# parameter gap after 3 steps is 1.2e-5 on the CPU); at 3e-4 the bound
# 1e-5 is a thirtieth of one step
STEP_OPT = dict(lr=3e-4, warmup=1, total_steps=10)


def test_train_step_matches_reference():
    """3 steps of Qwen3 smoke (chunked loss, remat full): losses,
    parameters, m and v within 1e-5."""
    jcfg, tcfg = _cfgs("qwen3_1_7b", loss_chunk=CHUNK, remat="full")
    jp = _ref_params(jcfg, "qwen3_1_7b")
    jo = jadamw.adamw_init(jp, jadamw.AdamWConfig(**STEP_OPT))
    model = params_from_numpy(tcfg, _np(jp), CPU, trainable=True)
    to = tadamw.adamw_init(dict(model.named_parameters()),
                           tadamw.AdamWConfig(**STEP_OPT))
    jstep = jax.jit(jsteps.make_train_step(jcfg,
                                           jadamw.AdamWConfig(**STEP_OPT)))
    tstep = tsteps.make_train_step(tcfg, tadamw.AdamWConfig(**STEP_OPT), CPU)
    rng = np.random.default_rng(7)
    moved = 0.0
    for _ in range(3):
        batch = _batch(jcfg.vocab, rng)
        before = params_to_numpy(tcfg, model)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        model, to, tm = tstep(model, to, batch)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-5 * float(jm["grad_norm"])
        got = params_to_numpy(tcfg, model)
        for w, want_t, got_t in (("params", jp, got),
                                 ("m", jo["m"], opt_state_to_numpy(
                                     tcfg, to)["m"]),
                                 ("v", jo["v"], opt_state_to_numpy(
                                     tcfg, to)["v"])):
            for (p, a), g in zip(jax.tree_util.tree_flatten_with_path(
                    want_t)[0], jax.tree.leaves(got_t)):
                assert np.abs(np.asarray(a) - g).max() <= 1e-5, (w, p)
        moved = max(moved, max(np.abs(a - b).max() for a, b in zip(
            jax.tree.leaves(got), jax.tree.leaves(before))))
    assert moved > 1e-4
    assert int(to["step"]) == 3
    assert all(p.grad is None for p in model.parameters())


def test_eval_step_and_frozen_model():
    _, tcfg = _cfgs("qwen3_1_7b")
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    batch = _batch(tcfg.vocab, np.random.default_rng(8))
    loss = tsteps.make_eval_step(tcfg, CPU)(model, batch)
    with torch.no_grad():
        assert float(loss) == float(tlm.lm_loss(tcfg, model, _tb(batch)))
    opt = tadamw.adamw_init(dict(model.named_parameters()),
                            tadamw.AdamWConfig())
    with pytest.raises(ValueError, match="trainable"):
        tsteps.make_train_step(tcfg, device=CPU)(model, opt, batch)


def test_train_entry_points_default_to_cuda(monkeypatch, tmp_path):
    _, tcfg = _cfgs("qwen3_1_7b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tsteps.make_train_step(tcfg),
                 lambda: tsteps.make_eval_step(tcfg),
                 lambda: ttrain.train(tcfg, steps=1, global_batch=1,
                                      seq_len=8, out=str(tmp_path))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_main_sets_the_cublas_workspace_and_resumes(monkeypatch, tmp_path,
                                                    capsys):
    """The CLI sets CUBLAS_WORKSPACE_CONFIG before its first step (on CUDA
    the deterministic step refuses cuBLAS without it), saves at its
    cadence, and a second call resumes."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    argv = ["--preset", "smoke", "--global-batch", "2", "--seq-len", "16",
            "--ckpt-every", "1", "--out", str(tmp_path), "--device", CPU]
    first = ttrain.main(argv + ["--steps", "2"])
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert len(first) == 2 and np.isfinite(first).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001", "step_00000002"]
    rest = ttrain.main(argv + ["--steps", "3"])
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert len(rest) == 1 and np.isfinite(rest).all()


def test_preset_config_matches_reference():
    for arch in TC.PORTED:
        for preset in ("smoke", "100m", "full"):
            jcfg = jtrain.preset_config(JC.get(arch), preset)
            tcfg = ttrain.preset_config(TC.get(arch), preset)
            jn = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
                jlm.param_specs(jcfg)))
            model = tlm.init_params(tcfg, torch.Generator(), "meta")
            assert tlm.count_params(model) == jn, (arch, preset)
            assert tcfg.remat == jcfg.remat
    for arch in ("deepseek_v3_671b", "llama4_scout_17b_a16e"):
        for preset in ("smoke", "100m"):
            jcfg = jtrain.preset_config(JC.get(arch), preset)
            tcfg = ttrain.preset_config(TC.get(arch), preset)
            for f in ("moe", "mla"):
                a, b = getattr(tcfg, f), getattr(jcfg, f)
                assert (a and vars(a)) == (b and vars(b)), (arch, preset, f)
    with pytest.raises(ValueError):
        ttrain.preset_config(TC.get("qwen3_1_7b"), "1b")


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

def test_lm_batches_are_byte_equal(tmp_path):
    np.testing.assert_array_equal(tdata.synthetic_tokens(5, 999, 500, 3),
                                  jdata.synthetic_tokens(5, 999, 500, 3))
    corpus = tmp_path / "corpus.bin"
    np.arange(1000, dtype=np.int32).tofile(corpus)
    for kw in (dict(vocab=1000, seq_len=64, global_batch=4, seed=7),
               dict(vocab=32768, seq_len=33, global_batch=3, seed=0,
                    mask_prob=0.3),
               dict(vocab=100, seq_len=16, global_batch=2,
                    bin_path=str(corpus))):
        for step in (0, 13):
            a = jdata.lm_batch_at_step(jdata.LMDataConfig(**kw), step)
            b = tdata.lm_batch_at_step(tdata.LMDataConfig(**kw), step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()
    cfg = dict(vocab=300, seq_len=8, global_batch=2, seed=1)
    it = tdata.lm_batches(tdata.LMDataConfig(**cfg), start_step=5)
    for step in (5, 6, 7):
        got = next(it)
        want = jdata.lm_batch_at_step(jdata.LMDataConfig(**cfg), step)
        assert got["inputs"].tobytes() == want["inputs"].tobytes()
    it.close()


def _bf16_state(jcfg):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    jo = jadamw.adamw_init(jp, jadamw.AdamWConfig())
    jo["m"] = jax.tree.map(lambda a: a + 0.5, jo["m"])
    jo["step"] = jnp.int32(7)
    return {"params": jp, "opt": jo}


def _same_checkpoint(root_a, root_b, step):
    """Both checkpoints: same keys in the same order, dtypes and bytes."""
    import json
    ma = json.loads((root_a / f"step_{step:08d}/manifest.json").read_text())
    mb = json.loads((root_b / f"step_{step:08d}/manifest.json").read_text())
    assert ma["keys"] == mb["keys"] and ma["dtypes"] == mb["dtypes"]
    za = np.load(root_a / f"step_{step:08d}/arrays.npz")
    zb = np.load(root_b / f"step_{step:08d}/arrays.npz")
    for k in ma["keys"]:
        assert za[k].dtype == zb[k].dtype and za[k].tobytes() \
            == zb[k].tobytes(), k
    return ma


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "gemma2_9b"])
def test_checkpoints_restore_across_packages(tmp_path, arch):
    """bf16 params and float32 moments: a checkpoint of the reference's
    manager restores in the port and, written back by the port's, is the
    same files; the port's checkpoint restores in the reference."""
    jcfg = j_smoke(JC.get(arch)).replace(mtp=True)
    tcfg = t_smoke(TC.get(arch)).replace(mtp=True)
    state = _bf16_state(jcfg)
    JManager(str(tmp_path / "j"), every=1).maybe_save(3, state, {"loss": 1})
    s, tree, meta = TManager(str(tmp_path / "j")).resume(CPU)
    assert s == 3 and meta == {"loss": 1}
    model = params_from_numpy(tcfg, tree["params"], CPU, trainable=True)
    opt = opt_state_from_numpy(tcfg, tree["opt"], CPU)
    assert model.embed.dtype == torch.bfloat16 and int(opt["step"]) == 7
    TManager(str(tmp_path / "t"), every=1).maybe_save(
        3, ttrain._state_tree(tcfg, model, opt), {"loss": 1})
    manifest = _same_checkpoint(tmp_path / "j", tmp_path / "t", 3)
    assert "params/mtp_block/attn/wq" in manifest["keys"]
    assert manifest["dtypes"]["params/embed"] == "bfloat16"
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        state)
    back, _ = j_restore(str(tmp_path / "t"), 3, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and np.asarray(a).tobytes() \
            == np.asarray(b).tobytes()
    flat, _ = t_restore(str(tmp_path / "t"), 3)
    assert flat["opt"]["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the trainer: trajectories, fail_at and resume, across packages
# ---------------------------------------------------------------------------

TRAIN = dict(steps=4, global_batch=2, seq_len=32, lr=1e-3, log_every=1)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """A step-0 checkpoint of the reference's weights (so that both
    trainers start from them), and the reference trainer's uninterrupted
    losses from it."""
    root = tmp_path_factory.mktemp("train")
    jcfg = jtrain.preset_config(JC.get("qwen3_1_7b"), "smoke").replace(**F32)
    tcfg = ttrain.preset_config(TC.get("qwen3_1_7b"), "smoke").replace(**F32)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    opt_cfg = jadamw.AdamWConfig(lr=TRAIN["lr"], total_steps=TRAIN["steps"])
    j_save(str(root / "step0"), 0, {"params": jp,
                                    "opt": jadamw.adamw_init(jp, opt_cfg)})

    def fresh(name):
        shutil.copytree(root / "step0", root / name)
        return str(root / name)

    want = jtrain.train(jcfg, out=fresh("ref"), ckpt_every=100, **TRAIN)
    return jcfg, tcfg, fresh, want


def test_train_trajectory_matches_reference(trainer):
    _, tcfg, fresh, want = trainer
    got = ttrain.train(tcfg, out=fresh("port"), ckpt_every=100, device=CPU,
                       **TRAIN)
    assert len(got) == len(want) == TRAIN["steps"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_fail_at_then_resume_is_bitwise(trainer, capsys):
    _, tcfg, fresh, _ = trainer
    whole = ttrain.train(tcfg, out=fresh("whole"), ckpt_every=100,
                         device=CPU, **TRAIN)
    out = fresh("failed")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        ttrain.train(tcfg, out=out, ckpt_every=2, fail_at=3, device=CPU,
                     **TRAIN)
    rest = ttrain.train(tcfg, out=out, ckpt_every=2, device=CPU, **TRAIN)
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert rest == whole[2:]


@pytest.mark.parametrize("first", ["reference", "port"])
def test_run_resumes_in_the_other_package(trainer, first):
    jcfg, tcfg, fresh, want = trainer
    out = fresh(f"from-{first}")
    runs = {"reference": lambda **kw: jtrain.train(jcfg, out=out, **kw,
                                                   **TRAIN),
            "port": lambda **kw: ttrain.train(tcfg, out=out, device=CPU,
                                              **kw, **TRAIN)}
    second = "port" if first == "reference" else "reference"
    with pytest.raises(RuntimeError, match="injected failure"):
        runs[first](ckpt_every=2, fail_at=3)
    rest = runs[second](ckpt_every=2)
    np.testing.assert_allclose(rest, want[2:], rtol=0, atol=1e-5)
