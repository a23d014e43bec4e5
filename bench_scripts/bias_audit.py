"""Importance-sampling bias audit.

The engine's default estimator draws cos(inc) ~ U[0, min(Ptra, 1)] with
exact ln-weight reweighting (scenarios/engine.py _inc_weighted); the
reference uses plain rejection over cos(inc) ~ U[0, 1]. Both estimate
the same marginal integral, so their lnZ means must agree within MC
noise. This script runs, per target (Kepler-10b, TOI-465.01):

* IS:    K keys at N = 1e6 draws/scenario (the product default), and
* plain: K keys at N = 1e7 draws/scenario (10x draws so the rejection
  estimator's variance is comparable),

then reports per-scenario lnZ mean +/- 2 s.e. for both, the difference
of means, and FPP confidence intervals. Results land in a JSON for
docs/parity.md.

Usage:  python bench_scripts/bias_audit.py [K] [out.json]
"""

import json
import os
import sys
import time as _time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from validate_golden import run_kepler10, run_toi465  # noqa: E402


def _runs(case_fn, K, N, importance_sampling):
    lnZs, fpps = [], []
    for k in range(K):
        t0 = _time.time()
        t = case_fn(N=N, key=1000 + k,
                    importance_sampling=importance_sampling)
        lnZs.append(np.asarray(t.lnZ, dtype=float))
        fpps.append(float(t.FPP))
        print(f"    key {k}: FPP={fpps[-1]:.4g} ({_time.time()-t0:.1f}s)",
              flush=True)
    scen = list(t.probs["scenario"].values)
    return np.array(lnZs), np.array(fpps), scen


def audit(name, case_fn, K=20, N_is=1_000_000, N_plain=10_000_000):
    print(f"== {name}: IS N={N_is:.0e} x {K} keys")
    lnZ_is, fpp_is, scen = _runs(case_fn, K, N_is, True)
    print(f"== {name}: plain rejection N={N_plain:.0e} x {K} keys")
    lnZ_pl, fpp_pl, _ = _runs(case_fn, K, N_plain, False)

    out = {"target": name, "K": K, "N_is": N_is, "N_plain": N_plain,
           "scenarios": []}
    print(f"{'scenario':10s} {'IS mean+/-2se':>22s} {'plain mean+/-2se':>22s}"
          f" {'dmean':>8s} {'overlap':>8s}")
    for j, s in enumerate(scen):
        a, b = lnZ_is[:, j], lnZ_pl[:, j]
        a = a[np.isfinite(a)]
        b = b[np.isfinite(b)]
        if len(a) < 2 or len(b) < 2:
            print(f"{s:10s} {'(-inf runs)':>22s}")
            out["scenarios"].append({"scenario": s, "finite_is": len(a),
                                     "finite_plain": len(b)})
            continue
        ma, sa = a.mean(), 2 * a.std(ddof=1) / np.sqrt(len(a))
        mb, sb = b.mean(), 2 * b.std(ddof=1) / np.sqrt(len(b))
        overlap = abs(ma - mb) <= (sa + sb)
        print(f"{s:10s} {ma:12.3f} +/- {sa:5.3f} {mb:12.3f} +/- {sb:5.3f}"
              f" {ma-mb:8.3f} {str(overlap):>8s}")
        out["scenarios"].append({
            "scenario": s, "is_mean": ma, "is_2se": sa,
            "plain_mean": mb, "plain_2se": sb, "dmean": ma - mb,
            "overlap": bool(overlap)})
    for label, f in (("IS", fpp_is), ("plain", fpp_pl)):
        print(f"FPP {label}: mean={f.mean():.4g} std={f.std(ddof=1):.4g} "
              f"[{f.min():.4g}, {f.max():.4g}]")
    out["fpp_is"] = {"mean": float(fpp_is.mean()),
                     "std": float(fpp_is.std(ddof=1)),
                     "values": fpp_is.tolist()}
    out["fpp_plain"] = {"mean": float(fpp_pl.mean()),
                        "std": float(fpp_pl.std(ddof=1)),
                        "values": fpp_pl.tolist()}
    return out


def main(K=20, out_json="/tmp/bias_audit.json"):
    results = [
        audit("Kepler-10b", run_kepler10, K=K),
        audit("TOI-465.01", run_toi465, K=K),
    ]
    with open(out_json, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {out_json}")


if __name__ == "__main__":
    K = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    out = sys.argv[2] if len(sys.argv) > 2 else "/tmp/bias_audit.json"
    main(K, out)
