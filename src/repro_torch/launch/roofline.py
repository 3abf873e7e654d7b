"""Roofline analysis over the dry-run records
(:mod:`repro_torch.launch.dryrun`) of one mesh: the one card by
default, or a production mesh (``--mesh pod16x16``, ``pod2x16x16``),
whose records are per device.

Per (arch × shape), with the rates of a chip model
(:class:`~repro_torch.hw.gpu.GpuChipModel`, the H100 SXM by default):

  compute term    = FLOPs_per_device / chip.peak_flops_bf16
  memory term     = bytes_per_device / chip.hbm_bw
  collective term = collective_bytes_per_device / chip.nvlink_bw_per_link

(per-device numerator ≡ global/(devices·rate) under SPMD balance; 0
collective bytes on one card; across the production meshes' 256 or 512
cards most collective bytes would cross the network between hosts, not
NVLink, so the collective term is a lower bound there).  Also reports MODEL_FLOPS/counted FLOPs
(the useful-compute ratio; catches remat and masked-attention waste),
the dominant term per cell, and whether the peak fits the chip's HBM.

Usage: python -m repro_torch.launch.roofline [--mesh card1x1] [--markdown]
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.hw.gpu import H100_SXM, GpuChipModel
from repro_torch.launch.dryrun import ARTIFACTS


def analyze_record(rec: dict, chip: GpuChipModel = H100_SXM) -> dict | None:
    if rec.get("status") != "OK" or "cost" not in rec:
        return None
    c = rec["cost"]
    n_dev = rec["devices"]
    peak_flops = chip.peak_flops_bf16
    t_compute = c["flops_per_device"] / peak_flops
    t_memory = c["bytes_per_device"] / chip.hbm_bw
    t_coll = c["collective_bytes_per_device"] / chip.nvlink_bw_per_link
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    hlo_global = c["flops_per_device"] * n_dev
    ratio = (rec["model_flops_global"] / hlo_global
             if hlo_global else float("nan"))
    bound = max(terms.values())
    # roofline fraction: useful model FLOPs per chip-second at the
    # bottleneck-implied step time, vs peak
    frac = (rec["model_flops_global"] / n_dev / bound) / peak_flops \
        if bound > 0 else 0.0

    # the structural HBM-traffic floor: resident state (weights,
    # optimizer state, caches: the argument bytes) streamed once a step
    arg_bytes = rec["memory"]["argument_bytes"]
    t_memory_adj = arg_bytes / chip.hbm_bw
    bound_adj = max(t_compute, t_memory_adj, t_coll)
    frac_adj = (rec["model_flops_global"] / n_dev / bound_adj) \
        / peak_flops if bound_adj > 0 else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "variant": rec.get("variant", "baseline"),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_adj_s": t_memory_adj,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_hlo_ratio": ratio,
        "roofline_fraction": frac,
        "roofline_fraction_adj": frac_adj,
        "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
        "fits_hbm": rec["memory"]["peak_bytes"] < chip.hbm_bytes,
    }


def load_all(mesh: str = "card1x1", variant: str = "baseline", *,
             chip: GpuChipModel = H100_SXM,
             directory: pathlib.Path | None = None) -> list[dict]:
    """:func:`analyze_record` of every record of ``mesh`` and
    ``variant`` under ``directory`` (the dry-run's ``ARTIFACTS``), in
    file-name order; SKIP and FAIL records as rows of their own."""
    rows = []
    root = ARTIFACTS if directory is None else pathlib.Path(directory)
    for path in sorted(root.glob(f"*_{mesh}*.json")):
        rec = json.loads(path.read_text())
        if rec.get("mesh") != mesh:
            continue
        if rec.get("variant", "baseline") != variant:
            continue
        if rec.get("status") == "SKIP":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": mesh, "skip": rec["reason"]})
            continue
        r = analyze_record(rec, chip)
        if r:
            rows.append(r)
        elif rec.get("status") == "FAIL":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": mesh, "fail": rec.get("error", "")[:80]})
    return rows


def render_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | mem(adj) s | "
           "collective s | dominant | model/HLO | frac | frac(adj) | "
           "peak GiB | fits |")
    sep = "|" + "---|" * 12
    lines = [hdr, sep]
    for r in rows:
        if "skip" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — "
                         f"| SKIP | — | — | — | — | — |")
            continue
        if "fail" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — "
                         f"| FAIL: {r['fail'][:40]} | — | — | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f} | "
            f"{r['t_memory_s']:.4f} | {r['t_memory_adj_s']:.4f} | "
            f"{r['t_collective_s']:.4f} | "
            f"**{r['dominant']}** | {r['model_hlo_ratio']:.3f} | "
            f"{r['roofline_fraction']:.3f} | "
            f"{r['roofline_fraction_adj']:.3f} | {r['peak_gib']:.2f} | "
            f"{'yes' if r['fits_hbm'] else 'NO'} |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="card1x1")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    rows = load_all(args.mesh, args.variant)
    if args.markdown:
        print(render_markdown(rows))
        return
    for r in rows:
        if "skip" in r:
            print(f"SKIP {r['arch']:24s} {r['shape']:12s} {r['skip'][:50]}")
        elif "fail" in r:
            print(f"FAIL {r['arch']:24s} {r['shape']:12s} {r['fail']}")
        else:
            print(f"     {r['arch']:24s} {r['shape']:12s} "
                  f"c={r['t_compute_s']:8.4f}s m={r['t_memory_s']:8.4f}s "
                  f"x={r['t_collective_s']:8.4f}s dom={r['dominant']:10s} "
                  f"frac={r['roofline_fraction']:.3f} "
                  f"peak={r['peak_gib']:6.2f}GiB")


if __name__ == "__main__":
    main()
