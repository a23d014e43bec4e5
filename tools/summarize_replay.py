"""Summarize a catalog-replay csv into a markdown results note.

Usage:  python tools/summarize_replay.py /tmp/catalog_replay.csv \
            [wall_seconds] > catalog_replay.md
"""

import sys

import numpy as np
import pandas as pd


def main(csv_path, wall_s=None):
    df = pd.read_csv(csv_path)
    n = len(df)
    fpp = df["FPP"].values
    lines = []
    lines.append(f"# Synthetic catalog replay — {n} TOIs @ 1e6 draws x "
                 "15 scenarios each")
    lines.append("")
    lines.append("Inputs are SYNTHETIC light curves built from the "
                 "published (Rp, Porb) per TOI (tools/catalog_replay.py) "
                 "with a synthetic TRILEGAL field — the per-TOI FPPs are "
                 "NOT comparable to the published values (different light "
                 "curves by construction); this sweep demonstrates "
                 "throughput and end-to-end stability at catalog scale.")
    lines.append("")
    if wall_s:
        lines.append(f"- wall time: {float(wall_s):.0f} s "
                     f"({float(wall_s)/n:.2f} s/target incl. first "
                     "compile; reference CPU path: ~60 s/target = "
                     f"~{60*n/3600:.1f} h for the same sweep)")
    lines.append(f"- all {n} targets produced finite FPP/NFPP: "
                 f"{bool(np.isfinite(fpp).all())}")
    lines.append(f"- FPP distribution: median {np.median(fpp):.3g}, "
                 f"p10 {np.quantile(fpp, 0.1):.3g}, "
                 f"p90 {np.quantile(fpp, 0.9):.3g}")
    lines.append(f"- FPP < 0.015 (validation threshold): "
                 f"{(fpp < 0.015).mean():.1%} of targets")
    lines.append(f"- FPP > 0.5 (likely FP on the synthetic input): "
                 f"{(fpp > 0.5).mean():.1%}")
    nfpp = df["NFPP"].values
    lines.append(f"- NFPP == 0 for {np.mean(nfpp == 0.0):.1%} "
                 "(single-star synthetic fields)")
    print("\n".join(lines))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/catalog_replay.csv",
         sys.argv[2] if len(sys.argv) > 2 else None)
