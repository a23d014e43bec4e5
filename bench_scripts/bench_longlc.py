"""Standing long-light-curve benchmark.

Times the FULL 15-scenario FPP run (calc_probs, N=1e6 draws/scenario)
on the unbinned TOI-1228 folded light curve — the longest real curve
the reference ships (examples/TOI1228_folded_lightcurve.csv, 20,100
rows) — at two shapes:

  * ``window``: the 8,055 in-transit-window points (|t| < 0.4 d), the
    same curve validate_golden.py's unbinned anchor uses;
  * ``full``:   all 20,100 points, no crop.

Each shape is run twice; the second (warm, compile-cache-served) wall
time is the standing number. Results append to
``bench_scripts/results/longlc.json`` and print as one JSON line per
shape, mirroring bench.py's schema.

Reference anchor: the reference evaluates the same 15 scenarios through
PyTransit serial/numba loops (likelihoods.py:346-357); its published
runtime numbers are for ~100-point binned curves only — there is no
reference baseline at 20k points, so ``vs_baseline`` is null here.

Usage:  python bench_scripts/bench_longlc.py
"""

import json
import os
import sys
import time as _time

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from validate_golden import REF, toi1228_field, make_trilegal  # noqa: E402

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", "longlc.json")


def load_curve(crop: bool):
    lc = pd.read_csv(os.path.join(REF, "TOI1228_folded_lightcurve.csv"))
    t = lc.x_fold.values
    y = lc.y.values + 1
    if crop:
        m = np.abs(t) < 0.4
        t, y = t[m], y[m]
    order = np.argsort(t)
    t, y = t[order], y[order]
    sigma = float(np.std(y[np.abs(t) > 0.25]))
    return t, y, sigma


def run_shape(label, crop, N=1000000):
    import jax
    from triceratops_tpu import target

    t_arr, flux, sigma = load_curve(crop)
    stars_df, inject = toi1228_field()
    tri = make_trilegal("/tmp/longlc_trilegal.csv",
                        Tmag_target=stars_df.iloc[0]["Tmag"])
    tgt = target.from_stars(stars_df, ID=stars_df.iloc[0]["ID"],
                            sectors=[1], trilegal_fname=tri)
    tgt.stars["fluxratio"] = inject["fluxratio"]
    tgt.stars["tdepth"] = inject["tdepth"]

    walls = []
    for rep in range(2):
        t0 = _time.time()
        tgt.calc_probs(t_arr, flux, sigma, P_orb=29.04992, N=N,
                       nsamples=20, verbose=0, key=jax.random.key(rep),
                       contrast_curve_file=os.path.join(REF,
                                                        "TOI1228_cc.tbl"),
                       filt="TESS")
        walls.append(_time.time() - t0)
    row = {
        "metric": f"longlc_fpp_wall_time_{label}",
        "value": round(walls[-1], 3),
        "unit": "s",
        "vs_baseline": None,
        "n_t": len(t_arr),
        "N": N,
        "walls": [round(w, 3) for w in walls],
        "FPP": float(tgt.FPP),
        "NFPP": float(tgt.NFPP),
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    rows = [run_shape("toi1228_window_8055pt", crop=True),
            run_shape("toi1228_full_20100pt", crop=False)]
    os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
    with open(RESULTS, "w") as f:
        json.dump(rows, f, indent=1)
    print("wrote", RESULTS)


if __name__ == "__main__":
    main()
