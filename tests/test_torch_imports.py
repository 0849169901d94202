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
from repro_torch.kernels.fused import fused_shuffle_reduce
from repro_torch.kernels.segment_reduce import segment_minmax, segment_sum
from repro_torch.kernels.sort_u32 import sort_lex
from repro_torch.kernels.spmv_ell import spmv_ell

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
            "repro_torch.apps.apriori; "
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
    Session(spec, RunConfig(device="cpu"))       # the only way onto the CPU


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
