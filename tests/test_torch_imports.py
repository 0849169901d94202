"""Guards of the port: no JAX, no ``repro``, no silent CPU fallback."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import RunConfig, Session
from repro_torch.apps import wordcount as wc
import repro_torch.configs as C
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused import fused_shuffle_reduce
from repro_torch.kernels.segment_reduce import segment_minmax, segment_sum
from repro_torch.kernels.sort_u32 import sort_lex
from repro_torch.kernels.spmv_ell import spmv_ell
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import lm
from repro_torch.models.config import smoke_config

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch.api, repro_torch.core.transfer, "
            "repro_torch.kernels.ops, repro_torch.kernels.spmv_ell, "
            "repro_torch.apps.pagerank, repro_torch.apps.sssp, "
            "repro_torch.apps.gimv, repro_torch.apps.kmeans, "
            "repro_torch.apps.apriori, repro_torch.models.lm, "
            "repro_torch.models.transfer, repro_torch.configs.gemma2_9b, "
            "repro_torch.launch.steps, repro_torch.kernels.flash_attention, "
            "repro_torch.stream, repro_torch.api.ckpt, repro_torch.core.ft, "
            "repro_torch.kernels.jitcache, repro_torch.data, "
            "repro_torch.serve, repro_torch.serve.loadgen, "
            "repro_torch.stream.server, repro_torch.dql, "
            "repro_torch.dql.derived, repro_torch.dql.workloads, "
            "repro_torch.core.distributed, repro_torch.optim, "
            "repro_torch.optim.compress, repro_torch.ckpt, "
            "repro_torch.launch.train, repro_torch.configs.recurrentgemma_2b, "
            "repro_torch.configs.xlstm_125m, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.launch.roofline, "
            "repro_torch.launch.report, repro_torch.launch.ranks, "
            "repro_torch.models.meshctx, repro_torch.models.shard; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    assert RunConfig().device == "cuda"
    with pytest.raises(ValueError):
        RunConfig(device="tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, _ = wc.make_job(np.zeros((2, 3), np.int32), 4)
    with pytest.raises(RuntimeError, match="cuda"):
        Session(spec, RunConfig())
    from repro_torch.api import LocalMesh, MeshConfig
    mesh = MeshConfig(LocalMesh({"data": 2}))
    with pytest.raises(RuntimeError, match="cuda"):
        Session(spec, RunConfig(mesh=mesh))      # shards live on the card
    Session(spec, RunConfig(device="cpu"))       # the only way onto the CPU
    Session(spec, RunConfig(device="cpu", mesh=mesh))


def test_lm_entry_points_default_to_cuda_and_raise_without_card(
        monkeypatch):
    cfg = smoke_config(C.get("gemma2_9b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: lm.init_params(cfg, torch.Generator()),
                 lambda: lm.init_caches(cfg, 2, 8),
                 lambda: make_prefill_step(cfg),
                 lambda: make_serve_step(cfg)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    with pytest.raises(ValueError):
        lm.init_caches(cfg, 2, 8, device="tpu")
    # the only way onto the CPU
    model = lm.init_params(cfg, torch.Generator(), device="cpu")
    logits = make_prefill_step(cfg, "cpu")(
        model, {"inputs": np.zeros((1, 4), np.int32)})
    assert tuple(logits.shape) == (1, 1, cfg.vocab)
    with pytest.raises(ValueError, match="lies on"):
        make_prefill_step(cfg, "meta")(model, {"inputs": np.zeros((1, 4))})


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    def qkv(device="cpu", hd=64, s=8, kh=2, dtype=torch.float32):
        return (torch.zeros((1, 4, s, hd), device=device, dtype=dtype),
                torch.zeros((1, kh, s, hd), device=device, dtype=dtype),
                torch.zeros((1, kh, s, hd), device=device, dtype=dtype))
    flash_attention(*qkv())
    # meta gives the output's shape (a dry-run), and nothing more
    out = flash_attention(*qkv(device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (1, 4, 8, 64)
    # a head dim no kernel takes: refused off the CPU (on meta as on the
    # card), the plain version on it
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(*qkv(hd=48, device="meta"))
    assert tuple(flash_attention(*qkv(hd=48)).shape) == (1, 4, 8, 48)
    with pytest.raises(ValueError, match="H % KH"):
        flash_attention(*qkv(kh=3))
    with pytest.raises(TypeError):
        flash_attention(*qkv(dtype=torch.float16))
    q, k, v = qkv()
    with pytest.raises(ValueError, match="same positions"):
        flash_attention(q, k[:, :, :4], v[:, :, :4])


def test_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    a = torch.zeros(4, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        sort_lex(a, a)
    with pytest.raises(ValueError):
        segment_sum(a, torch.zeros((4, 1), device=meta), 3)
    with pytest.raises(ValueError):
        segment_minmax("min", a, torch.zeros((4, 1), device=meta), 3)
    with pytest.raises(ValueError):
        spmv_ell(a[None], torch.zeros((1, 4), device=meta), 3)
    with pytest.raises(ValueError):
        fused_shuffle_reduce(a, a, torch.zeros((4, 1), device=meta),
                             torch.ones(4, dtype=torch.bool, device=meta),
                             torch.ones(4, dtype=torch.int8, device=meta),
                             a, out_dtype=torch.float32)


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    env = dict(os.environ, PYTHONPATH="")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script in (ROOT / "chip_smoke.py", lone):
        if torch.cuda.is_available() and script != lone:
            continue
        res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


def test_serve_and_dql_entry_points_default_to_cuda(monkeypatch):
    from repro_torch import dql
    from repro_torch.core.kvstore import make_kv
    from repro_torch.dql import workloads as wl
    from repro_torch.dql.derived import coalesce_rows_dql
    from repro_torch.serve import ServeTier, loadgen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kv = make_kv(np.arange(4, dtype=np.int32),
                 {"w": np.zeros((4, 2), np.int32)})
    for make in (lambda: loadgen.make_fleet(ServeTier(), 1),
                 lambda: wl.wordcount_query(4).compile(),
                 lambda: dql.evaluate(wl.wordcount_query(4), kv),
                 lambda: coalesce_rows_dql(np.zeros(2, np.int32), {},
                                           np.int8([1, -1]))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    # the only way onto the CPU
    vals, valid = dql.evaluate(wl.wordcount_query(4), kv, device="cpu")
    assert valid.tolist() == [True, False, False, False]
    assert vals["c"][0] == 8
