#!/usr/bin/env python3
"""Ablations of the bf16 flash kernel: which part of a consumer's work
bounds it at a head dim.

    python3 tools/flash_probes.py [VARIANT ...]

For each variant (all of them by default) this copies the checkout's
``src`` into the git-ignored ``build/flash-probes/<variant>/src``, applies
the variant's edits to the copy's ``csrc/flash_attention.cu``, and times
the copy's ``flash_attention`` in a process of its own (CUDA events, mean
of 20 launches after a warm-up), bf16 with q at std 20 as phase 2's
``time_flash_attention``, at three layers: HuBERT X-Large's
(``chip_smoke.FLASH_HUBERT``, hd 80, not causal), StableLM 12B's
(``FLASH_STABLELM``, hd 160, causal) and Qwen3-1.7B's (``FLASH_QWEN``, hd
128, causal).  The variants:

  base       the kernel as it is;
  noexp      p is the exponent's argument: no ex2 a score (the
             special-function unit's share of the time);
  nosoftmax  no softmax (P is S rounded to bf16): the two products, the
             barriers and the packing of P;
  nopv       no P.V;
  noqk       no Q.K^T (the softmax runs on stale scores);
  h80s2      a ring of 2 K/V stages instead of 4 at hd 80 (100 KB of
             shared memory instead of 180);
  h128s3     a ring of 3 stages instead of 2 at hd 128 (225 KB);
  h128box32, h128box16
             hd 128 read in boxes of 32 or 16 columns (the 64- or 32-byte
             swizzle) instead of 64: the same work in hd 160's and 80's
             narrower TMA rows.

Only base, h80s2, h128s3 and the box variants compute the function, and
they are held within ``chip_smoke.flash_bound``; the others' outputs are
wrong and only their times mean anything.  Prints the card's name and
power limit and one JSON line a variant; needs one CUDA card.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "flash-probes"
CU = Path("repro_torch/kernels/csrc/flash_attention.cu")

_PV = ("__device__ inline void pv_product(float* o, uint32_t (*pa)[4],\n"
       "                                  const __nv_bfloat16* Vst) {\n")
_QK = ("__device__ inline void qk_product(float* s, const __nv_bfloat16* Qs,"
       "\n                                  const __nv_bfloat16* Kst, int c) "
       "{\n")
_EXP = "const float pe = ex2(fmaf(sc[4 * j + e], ks, -m[e >> 1]));"
_SOFTMAX = "  auto softmax = [&](int t) {\n"
_BOX = ("static constexpr int BOX = box_of(HD) < box_of(VD) ? box_of(HD) : "
        "box_of(VD);")
_STAGES = "static constexpr int STAGES = HD == 80 ? 4 : 2;"

# variant -> (old, new) edits of flash_attention.cu, each old text unique
VARIANTS = {
    "base": [],
    "noexp": [(_EXP, "const float pe = fmaf(sc[4 * j + e], ks, "
                     "-m[e >> 1]);")],
    "nosoftmax": [(_SOFTMAX, _SOFTMAX + "    corr[0] = corr[1] = 1.f;\n"
                                        "    return;\n")],
    "nopv": [(_PV, _PV + "  return;\n")],
    "noqk": [(_QK, _QK + "  return;\n")],
    "h80s2": [(_STAGES, _STAGES.replace("? 4", "? 2"))],
    "h128s3": [(_STAGES, _STAGES.replace(": 2", ": HD == 128 ? 3 : 2"))],
    **{f"h128box{n}": [(_BOX, _BOX.replace(
        "= box_of(HD) <", f"= HD == 128 ? {n} : box_of(HD) <"))]
       for n in (32, 16)},
}
CHECKED = ("base", "h80s2", "h128s3", "h128box32", "h128box16")


def prepare(name: str) -> Path:
    """The variant's copy of ``src`` with its edits applied."""
    src = OUT / name / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(ROOT / "src", src, ignore=shutil.ignore_patterns(
        "build", "__pycache__"))
    path = src / CU
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to edit is not unique in "
                             f"{CU}: {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return src


def time_variant(src: str, name: str) -> None:
    """Build the copy under ``src`` and time its kernel at the layers."""
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {"variant": name}
    for label, (b, h, kh, s, hd), causal in (
            ("hd80", cs.FLASH_HUBERT, False),
            ("hd160", cs.FLASH_STABLELM, True),
            ("hd128", cs.FLASH_QWEN, True)):
        q, k, v = (torch.randn((b, n, s, hd), generator=gen, device=dev)
                   .mul_(sd).to(torch.bfloat16)
                   for n, sd in ((h, cs.FLASH_Q_SCALES[-1]), (kh, 1),
                                 (kh, 1)))
        fn = lambda: flash_attention(q, k, v, causal=causal)
        if name in CHECKED:
            want, tol = cs.flash_bound(q, k, v, dict(causal=causal),
                                       cs.FLASH_REL["bfloat16"])
            res[f"share_{label}"] = cs.flash_share(fn(), want, tol)[1]
            if not res[f"share_{label}"] <= 1:
                raise AssertionError(f"{name} {label}: {res}")
            del want, tol
        res[f"ms_{label}"] = cs.cuda_ms(fn, reps=20)
        keys = cs.keys_in_range(s, 0) if causal else s * s
        res[f"tflops_{label}"] = 4 * b * h * hd * keys / res[
            f"ms_{label}"] / 1e9
        del q, k, v
    print(json.dumps(res), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--time"]:
        time_variant(*argv[1:3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("flash_probes: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    rc = 0
    for name in argv or list(VARIANTS):
        src = prepare(name)
        try:
            done = subprocess.run([sys.executable, __file__, "--time",
                                   str(src), name], timeout=600,
                                  check=False)
            rc = rc or done.returncode
        except subprocess.TimeoutExpired:
            print(f"{name}: timed out", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
