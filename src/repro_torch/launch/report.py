"""Render the dry-run's tables into one markdown file.

Counterpart of ``repro.launch.report``, which rewrites marked sections of
an ``EXPERIMENTS.md`` that the repository does not have.  Here the tables
go to the file ``--out`` names:

- the roofline table of every baseline record (``roofline.markdown_table``);
- :func:`perf_table`, the variants of :data:`HILL_CELLS` side by side.

A variant is a record written under its own tag with its config changed
through ``--set``; the port's variants are the ``remat`` modes (the
reference's ``a2a`` variants dry-run a GSPMD-sharded step across chips,
which the port does not build: its ``a2a`` layer runs on ranks, see
``repro_torch.launch.ranks``; its blockwise ones have no meaning here:
every cache-less attention runs the flash kernel).  Make them with

  python -m repro_torch.launch.dryrun --arch chameleon_34b --shape \\
      train_4k --tag remat_dots --set remat=dots

The reference's multi-pod summary waits for the LM sharded across
cards (ROADMAP.md Queue 1).

  python -m repro_torch.launch.report --out build/dryrun/REPORT.md
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import record_path
from repro_torch.launch.roofline import analyze, load_all, markdown_table

# (arch, shape, tags): "baseline" is each config's own remat ("full")
HILL_CELLS = [
    ("deepseek_v3_671b", "train_4k",
     ["baseline", "remat_none", "remat_dots"]),
    ("llama4_scout_17b_a16e", "prefill_32k",
     ["baseline", "remat_none", "remat_dots"]),
    ("chameleon_34b", "train_4k",
     ["baseline", "remat_none", "remat_dots"]),
]


def perf_table() -> str:
    out = []
    for arch, shape, tags in HILL_CELLS:
        out.append(f"\n**{arch} × {shape}**\n")
        out.append("| variant | compute s | memory s | collective s "
                   "| t_step | RF | vs baseline |")
        out.append("|---|---|---|---|---|---|---|")
        base_step = None
        for tag in tags:
            f = record_path(arch, shape, tag)
            if not f.exists():
                out.append(f"| {tag} | (not traced) | | | | | |")
                continue
            a = analyze(json.loads(f.read_text()))
            if base_step is None:
                base_step = a["t_step_s"]
            out.append(
                f"| {tag} | {a['t_compute_s']:.1f} | {a['t_memory_s']:.1f} "
                f"| {a['t_collective_s']:.1f} | **{a['t_step_s']:.1f}** "
                f"| {a['roofline_fraction']:.3f} "
                f"| {base_step / a['t_step_s']:.1f}× |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="markdown file to write")
    args = ap.parse_args(argv)
    md = ("# Dry-run on meta against one H100 (modeled, not measured)\n\n"
          "## Roofline (baseline)\n\n"
          + markdown_table(load_all("baseline")) + "\n\n"
          "## Variants\n" + perf_table() + "\n")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(md)
    print(f"{out} written")


if __name__ == "__main__":
    main()
