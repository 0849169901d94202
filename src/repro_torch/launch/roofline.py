"""Roofline analysis over the dry-run's records, against one H100.

Counterpart of ``repro.launch.roofline``, with its formulas.  For every
(arch x shape x tag) record that ``launch.dryrun`` wrote:

  compute term    = flops / 989 TFLOP/s       (bf16 tensor cores, dense)
  memory term     = bytes / 3.35 TB/s         (HBM3)
  collective term = collective bytes / 450 GB/s (NVLink 4; 0 on one card,
                    one rank's collectives on a mesh's records)

plus MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill) / 2·N_active·B + the
KV read (decode), the useful-compute ratio MODEL_FLOPS / flops, the
dominant term, and the roofline fraction

  RF = (MODEL_FLOPS / (devices · peak)) / max(terms)

("ideal useful-compute time over modeled execution time"); a decode step
is held to HBM instead: the useful bytes (every active parameter and the
cache read once) over the memory rate.  The constants are the H100 SXM
data sheet's (``launch.mesh``): these times are modeled, not measured.

The reference's quirks are kept, so that the two agree number for
number: a train step counts 6·N_active·T with no attention term; the
decode KV term counts ``n_heads · head_dim`` a position, MLA's latent
cache included; cache bytes are counted at 2 an element, the xLSTM
cells' float32 states included.  Parameters are counted from the port's
own plan (``lm.plan_model``).

  python -m repro_torch.launch.roofline [--tag baseline] [--md] \\
      [--mesh pod16x16]
"""
from __future__ import annotations

import argparse
import json
import math

from repro_torch.launch.dryrun import ART, MESH
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS


def model_params(cfg) -> int:
    """Total parameter count from the port's plan."""
    from repro_torch.models import lm
    return int(sum(math.prod(s.shape) for s in lm.plan_model(cfg).values()))


def active_params(cfg) -> int:
    """Active (per-token) parameters: subtract unrouted experts."""
    total = model_params(cfg)
    if cfg.moe is None:
        return total
    per_expert = cfg.d_model * 2 * cfg.moe.d_ff_expert + \
        cfg.moe.d_ff_expert * cfg.d_model
    n_moe_layers = sum(1 for k in cfg.layer_kinds if k == "attn_moe")
    return total - n_moe_layers * (cfg.moe.num_experts - cfg.moe.top_k) * \
        per_expert


def _cell(shape):
    """The cell ``shape`` names in ``SHAPES``, or ``shape`` itself when it
    is a ``ShapeCell`` (a cell cut to fit one card)."""
    from repro_torch.models.config import SHAPES
    return SHAPES[shape] if isinstance(shape, str) else shape


def model_flops(arch: str, shape, devices: int = 1) -> float:
    import repro_torch.configs as C
    cfg = C.get(arch)
    cell = _cell(shape)
    n_act = active_params(cfg)
    if cfg.embed_inputs:
        # embeddings don't do matmul work per token
        n_act -= cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 0)
    tokens = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        return 6.0 * n_act * tokens
    if cell.kind == "prefill":
        return 2.0 * n_act * tokens
    # decode: one token per sequence + attention over the KV cache
    attn = 0.0
    if cfg.family not in ("xlstm",):
        kv_read = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * \
            min(cell.seq_len, 10**9)
        attn = kv_read * cell.global_batch
    return 2.0 * n_act * cell.global_batch + attn


def useful_decode_bytes(arch: str, shape) -> float:
    """Minimum HBM traffic for one decode step: read every live parameter
    once + read the KV/recurrent cache once (global bytes)."""
    import repro_torch.configs as C
    from repro_torch.models import lm
    cfg = C.get(arch)
    cell = _cell(shape)
    pbytes = 2.0 * active_params(cfg)          # bf16
    caches = lm.init_caches(cfg, cell.global_batch, cell.seq_len,
                            device="meta")
    leaves = [caches["pos"]] + [t for layer in caches["layers"]
                                for part in layer.values()
                                for t in part.values()]
    return pbytes + 2.0 * sum(t.numel() for t in leaves)


def analyze(rec: dict) -> dict:
    """The record's terms, dominant term and roofline fraction; its cell is
    ``rec["cell"]`` where the record has one, else ``SHAPES``' cell of
    that name."""
    from repro_torch.models.config import ShapeCell
    cell = ShapeCell(rec["shape"], **rec["cell"]) if "cell" in rec \
        else _cell(rec["shape"])
    est = rec.get("estimated") or {
        "flops_per_device": rec["full"]["flops"],
        "bytes_per_device": rec["full"]["bytes"],
        "collective_bytes_per_device": rec["full"]["coll"],
    }
    devices = rec["devices"]
    fl = est["flops_per_device"]
    by = est["bytes_per_device"]
    coll = sum(est["collective_bytes_per_device"].values())
    terms = {"compute": fl / PEAK_FLOPS, "memory": by / HBM_BW,
             "collective": coll / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], cell, devices)
    t_step = max(terms.values())
    is_decode = cell.kind == "decode"
    if is_decode:
        # decode is inherently memory-bound: the roofline resource is HBM.
        ub = useful_decode_bytes(rec["arch"], cell)
        t_ideal = (ub / devices) / HBM_BW
        useful = ub / max(by * devices, 1e-9)
    else:
        t_ideal = mf / (devices * PEAK_FLOPS)
        useful = mf / max(fl * devices, 1e-9)
    return {
        **{f"t_{k}_s": v for k, v in terms.items()},
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": useful,
        "roofline_fraction": t_ideal / max(t_step, 1e-30),
        "roofline_kind": "memory(HBM)" if is_decode
        else "compute(tensor cores)",
        "t_step_s": t_step,
        "temp_gib": (rec["full"]["memory"]["temp_size"] or 0) / 2**30,
        "args_gib": (rec["full"]["memory"]["argument_size"] or 0) / 2**30,
    }


def load_all(tag: str, mesh: str = MESH):
    out = []
    for f in sorted(ART.glob(f"*__{mesh}__{tag}.json")):
        rec = json.loads(f.read_text())
        if rec["arch"] == "qwen3-1.7b":   # alias duplicate of qwen3_1_7b
            continue
        try:
            rec["analysis"] = analyze(rec)
        except Exception as e:      # one bad record is a row, not a crash
            rec["analysis"] = {"error": str(e)}
        out.append(rec)
    return out


def markdown_table(recs) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| useful ratio | RF | temp GiB |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in recs:
        a = r["analysis"]
        if "error" in a:
            rows.append(f"| {r['arch']} | {r['shape']} | ERR {a['error']} "
                        "| | | | | | |")
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {a['t_compute_s']:.3f} "
            f"| {a['t_memory_s']:.3f} | {a['t_collective_s']:.3f} "
            f"| **{a['dominant']}** | {a['useful_ratio']:.2f} "
            f"| {a['roofline_fraction']:.3f} | {a['temp_gib']:.0f} |")
    return hdr + "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--mesh", default=MESH,
                    help="the records of this mesh (launch.dryrun --mesh)")
    args = ap.parse_args(argv)
    recs = load_all(args.tag, args.mesh)
    if args.md:
        print(markdown_table(recs))
        return
    for r in recs:
        a = r["analysis"]
        if "error" in a:
            print(f"{r['arch']:26s} {r['shape']:12s} ERR {a['error']}")
            continue
        print(f"{r['arch']:26s} {r['shape']:12s} "
              f"C {a['t_compute_s']:8.3f}s M {a['t_memory_s']:8.3f}s "
              f"X {a['t_collective_s']:8.3f}s -> {a['dominant']:10s} "
              f"useful {a['useful_ratio']:5.2f} RF {a['roofline_fraction']:.3f}")


if __name__ == "__main__":
    main()
