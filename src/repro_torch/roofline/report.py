"""Roofline report: dry-run cell JSONs → a markdown table (port of
``repro.roofline.report``).

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun_torch]
                                                         [--mesh pod16x16]

One row per cell JSON that ran (skipped cells are listed below the table
with their reason), sorted by arch, shape and rules: the three roofline
terms (spec H100 numbers, not measured), the dominant one, useful_ratio,
the roofline fraction, GiB per device and whether it fits in 80 GB.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(dir_: str, mesh: str | None) -> list[dict]:
    rows = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            d = json.load(f)
        if mesh and d["mesh"] != mesh:
            continue
        rows.append(d)
    rows.sort(key=lambda d: (d["arch"], d["shape"], d.get("rules", "")))
    return rows


def table(rows: list[dict]) -> str:
    out = ["| arch | shape | rules | compute (s) | memory (s) | collective (s) | dominant "
           "| useful | roofline frac | GiB/dev | fits 80 GB |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    skipped = []
    for d in rows:
        if d.get("skipped"):
            skipped.append(f"- {d['arch']} × {d['shape']}: {d['skipped']}")
            continue
        t = d["terms"]
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['rules']} "
            f"| {t['compute_s']:.4g} | {t['memory_s']:.4g} "
            f"| {t['collective_s']:.4g} | {t['dominant']} "
            f"| {d['useful_ratio']:.3f} | {d['roofline_fraction']:.3f} "
            f"| {d['memory'].get('total_gb', 0):.1f} | {'yes' if d['memory'].get('fits') else 'no'} |")
    return "\n".join(out + ([""] + skipped if skipped else []))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--all-meshes", action="store_true")
    args = ap.parse_args(argv)
    print(table(load(args.dir, None if args.all_meshes else args.mesh)))


if __name__ == "__main__":
    main()
