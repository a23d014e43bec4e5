"""Benchmark: full FPP run (15 scenarios x 1e6 MC draws) on one GPU.

Mirrors the reference's headline workload (BASELINE.md): TOI-465-class
configuration — single target star, ~100-point binned light curve,
N = 1e6 draws per scenario, 20x supersampling — for which the reference's
vectorized CPU path takes ~60.5 s per run (examples/example.ipynb cell
14). Offline fixtures (synthetic star field + TRILEGAL table of the same
size) keep the benchmark network-free; the compute is identical to a real
target run.

Fails without a GPU. Prints the device (platform, device_kind, count)
and the card's name and power limit on one line, then ONE json line:
median wall time of 3 warm calc_probs runs (distinct RNG keys so the
async runtime cannot dedupe them), with vs_baseline = 60.5 / median.
`value` is the median; min / max / spread
ride along so deltas can be judged against run-to-run noise (the
reference's own protocol is a 20-run loop, example.ipynb cell 14).
"""

import json
import subprocess
import sys
import tempfile
import time as _time

import numpy as np

BASELINE_S = 60.5


def build_fixtures(tmpdir):
    import pandas as pd
    from triceratops_tpu.constants import G, MSUN, RSUN, REARTH
    from triceratops_tpu.core.kepler import projected_z
    from triceratops_tpu.ops.occult import occult_quad_deficit
    import jax.numpy as jnp

    # TOI-465-like host + transit (depth ~ 2600 ppm)
    P, M_s, R_s, rp = 3.18, 1.09, 1.06, 5.5
    n_t = 100
    time = np.linspace(-0.15, 0.15, n_t)
    a = ((G * M_s * MSUN) / (4 * np.pi**2) * (P * 86400.0) ** 2) ** (1 / 3)
    k = rp * REARTH / (R_s * RSUN)
    z, front = projected_z(jnp.asarray(time), 0.0, P, a / (R_s * RSUN),
                           np.deg2rad(89.0), 0.0, 0.0)
    D = np.asarray(occult_quad_deficit(
        jnp.asarray(k, jnp.float32), z.astype(jnp.float32),
        jnp.float32(0.35), jnp.float32(0.25))) * np.asarray(front)
    sigma = 4e-4
    rng = np.random.default_rng(42)
    flux = 1.0 - D + rng.normal(0, sigma, n_t)

    stars = pd.DataFrame([dict(
        ID="465", Tmag=9.7, Jmag=8.9, Hmag=8.7, Kmag=8.6, ra=90.0,
        dec=-60.0, mass=M_s, rad=R_s, Teff=5950.0, plx=11.0,
        **{"sep (arcsec)": 0.0, "PA (E of N)": 0.0})])

    # synthetic background population (~3000 stars, typical 0.1 deg^2
    # field size), physically consistent (populations/synthetic.py)
    from triceratops_tpu.populations.synthetic import make_synthetic_trilegal
    tri = make_synthetic_trilegal(f"{tmpdir}/bench_trilegal.csv",
                                  Tmag_target=9.7, n_stars=3000, seed=42)
    return stars, tri, time, flux, sigma, P


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card (a child
    process that never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_gpu(count: int = 1):
    """JAX's devices; exits unless they are at least ``count`` GPUs.
    Prints the device and the card on one line each."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        sys.exit(f"needs {count} GPU(s); JAX found {len(devs)} "
                 f"{devs[0].platform!r} device(s)")
    print(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)}", flush=True)
    print(f"card: {card_line()}", flush=True)
    return devs


def main():
    from triceratops_tpu import target

    require_gpu()
    with tempfile.TemporaryDirectory() as tmpdir:
        stars, tri, time, flux, sigma, P = build_fixtures(tmpdir)
        t = target.from_stars(stars, ID=465, sectors=[1],
                              trilegal_fname=tri)
        t.calc_depths(tdepth=0.0026)
        walls = _timed_runs(t, time, flux, sigma, P)
    med = float(np.median(walls))
    print(json.dumps({
        "metric": "full_fpp_wall_time_15_scenarios_1e6_draws",
        "value": round(med, 3), "unit": "s",
        "vs_baseline": round(BASELINE_S / med, 2),
        "runs": [round(w, 3) for w in walls],
        "min": round(min(walls), 3), "max": round(max(walls), 3),
        "spread": round(max(walls) - min(walls), 3),
    }))


def _timed_runs(t, time, flux, sigma, P):
    import jax

    def run(key_int):
        t.calc_probs(time, flux, sigma, P_orb=P, N=1000000, nsamples=20,
                     verbose=0, key=jax.random.key(key_int))
        return t.FPP, t.NFPP

    run(0)  # compile + warm caches
    walls = []
    for i in range(1, 4):  # distinct keys: no dedupe of repeat dispatches
        t0 = _time.time()
        run(i)
        walls.append(_time.time() - t0)
    return walls


if __name__ == "__main__":
    main()
