"""Quantify the long-LC in-transit-window approximation across keys.

Runs the full 15-scenario TOI-1228 FPP (N = 1e6 draws) at both long-LC
shapes — the 8,055-point |t| < 0.4 d in-transit window and the full
20,099-point unbinned curve — over several independent PRNG keys, and
reports per-shape FPP mean/sd plus the window-vs-full delta. The
decision rule: windowing ships as a documented
``calc_probs(lc_window=...)`` option iff the shape delta is within the
key-to-key Monte-Carlo noise of the full curve.

Usage:  python bench_scripts/longlc_window_keys.py [n_keys]
"""

import json
import os
import sys
import time as _time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from validate_golden import REF, toi1228_field, make_trilegal  # noqa: E402
from bench_longlc import load_curve  # noqa: E402

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", "longlc_window_keys.json")


def run_keys(label, crop, n_keys, N=1000000):
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

    fpps, walls = [], []
    for i in range(n_keys):
        t0 = _time.time()
        tgt.calc_probs(t_arr, flux, sigma, P_orb=29.04992, N=N,
                       nsamples=20, verbose=0,
                       key=jax.random.key(1000 + i),
                       contrast_curve_file=os.path.join(REF,
                                                        "TOI1228_cc.tbl"),
                       filt="TESS")
        walls.append(_time.time() - t0)
        fpps.append(float(tgt.FPP))
        print(f"{label} key {i}: FPP={tgt.FPP:.5f} ({walls[-1]:.1f}s)",
              flush=True)
    fpps = np.array(fpps)
    return dict(fpps=fpps.tolist(), mean=float(fpps.mean()),
                sd=float(fpps.std(ddof=1)),
                walls=[round(w, 1) for w in walls])


def main(n_keys=4):
    out = {"window": run_keys("window", True, n_keys),
           "full": run_keys("full", False, n_keys)}
    delta = out["window"]["mean"] - out["full"]["mean"]
    comb_sd = float(np.hypot(out["window"]["sd"], out["full"]["sd"]))
    out["delta_window_minus_full"] = delta
    out["combined_sd"] = comb_sd
    out["within_noise"] = bool(abs(delta) <= 2.0 * comb_sd)
    os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
    with open(RESULTS, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, dict)}))
    print(f"wrote {RESULTS}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
