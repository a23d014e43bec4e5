"""Smoke run of the FPP pipeline on one NVIDIA GPU (or four, with --mesh).

    python chip_smoke.py          # one card: main path + core vs reference
    python chip_smoke.py --mesh   # four cards: sharded batch vs one card

Phases, all in this one process; any failure exits non-zero:

1. device: JAX must find a GPU; prints its kind, the device count and the
   card's name and power limit from nvidia-smi.
2. main path at full width: ``target.from_stars -> calc_depths ->
   calc_probs`` on the benchmark workload (bench.build_fixtures: TOI-465-
   like host, 3,000-star synthetic TRILEGAL table, 100-point curve),
   N = 1e6 draws x 15 scenarios, nsamples = 20. The first call is
   compile/set-up; three warm calls with distinct keys are timed.
3. core vs reference: the shipped f32 likelihood core against the f64
   ``exact=True`` path (midpoint-rule supersampling, exact occultation
   kernel, run on the host CPU backend) at 65,536 draws on the 100-point
   curve (ns = 20) and at 8,192 draws on a seeded 20,099-point curve
   (ns = 1).

With --mesh only the sharded path runs: ``batch_fpp_full`` for 4 seeded
targets at N = 1e6 on a 2x2 (targets, draws) mesh, against the same batch
on a 1x1 mesh on card 0.

The last line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

N_MAIN = 1_000_000
N_CORE = 65_536
N_LONG = 20_099
N_CORE_LONG = 8_192  # the f64 reference runs on the host CPU
EXPTIME = 0.00139

# f32 fast core vs f64 references (chip_smoke phase 3). Deficit gates:
# against the same fast algorithm in f64 the difference is f32 rounding
# alone (docs/parity.md f32 ledger: 1.22e-6 worst case; TF32 contractions
# would miss by orders of magnitude); against the exact midpoint-rule
# path the 4-node Gauss-Legendre exposure integral adds up to ~2.1e-6
# near contact, so the repo's 5e-6 deficit gate applies there.
GATE_DD_PRECISION = 2e-6
GATE_DD_EXACT = 5e-6
# per-draw lnL, over draws within 20 nats of the best reference draw
# (they carry all but e^-20 of the evidence); far-off draws differ by
# dD x residual / sigma^2 summed over every in-transit point, which is
# gated relative to |lnL| instead (tests/test_fastcore.py EB gate)
GATE_LNL_P99, GATE_LNL_MAX, LNL_TOP_NATS = 0.05, 1.0, 20.0
GATE_LNL_REL_P99 = 1e-3
GATE_LNZ = 1e-2


def peak_bytes(device):
    """peak_bytes_in_use of a device (None where the backend keeps no
    allocator statistics, as the CPU backend does)."""
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 2: the main path at full width
# ---------------------------------------------------------------------------

def main_path(tmpdir: str, N: int = N_MAIN, n_warm: int = 3):
    import jax
    from bench import build_fixtures
    from triceratops_tpu import target

    stars, tri, t_lc, flux, sigma, P = build_fixtures(tmpdir)
    t = target.from_stars(stars, ID=465, sectors=[1], trilegal_fname=tri)
    t.calc_depths(tdepth=0.0026)

    def run(key_int):
        t0 = time.perf_counter()
        t.calc_probs(t_lc, flux, sigma, P_orb=P, N=N, nsamples=20,
                     verbose=0, key=jax.random.key(key_int))
        return time.perf_counter() - t0

    setup = run(0)
    walls = [run(i) for i in range(1, n_warm + 1)]
    peak = peak_bytes(jax.devices()[0])
    probs = t.probs["prob"].to_numpy()
    print(f"main path: calc_probs N={N} x {len(probs)} scenarios, n_t="
          f"{len(t_lc)}, nsamples=20: compile/set-up {setup:.3f} s, warm "
          f"walls {[round(w, 4) for w in walls]} s, median "
          f"{float(np.median(walls)):.4f} s, peak_bytes_in_use {peak}",
          flush=True)
    print(f"main path: FPP={t.FPP:.6g} NFPP={t.NFPP:.6g} "
          f"sum(probs)={probs.sum():.9f}", flush=True)
    lnZ = np.asarray(t.lnZ)
    check(len(probs) == 15, f"{len(probs)} scenarios, expected 15")
    check(abs(probs.sum() - 1.0) <= 1e-6, f"probs sum to {probs.sum()}")
    check(0.0 <= t.FPP <= 1.0 and 0.0 <= t.NFPP <= 1.0,
          f"FPP={t.FPP} NFPP={t.NFPP} outside [0, 1]")
    check(np.all(np.isfinite(lnZ) | np.isneginf(lnZ)),
          f"lnZ not finite or -inf: {lnZ}")
    check(t.FPP < 0.5, f"FPP={t.FPP} on a clean planet injection")
    return walls


# ---------------------------------------------------------------------------
# Phase 3: shipped f32 core vs the f64 reference
# ---------------------------------------------------------------------------

def _draws(N: int, seed: int):
    """Seeded planet draws that transit (impact parameter < 1 + k) on the
    benchmark host's orbit, with random eccentricity and dilution."""
    rng = np.random.default_rng(seed)
    k = 10 ** rng.uniform(-2, -0.7, N)
    aR = np.full(N, 9.2)
    inc = np.arccos(rng.uniform(0, 1, N) * (1 + k) / aR)
    return dict(k=k, P=np.full(N, 3.18), a_R=aR, inc=inc,
                e=rng.uniform(0, 0.5, N), w=rng.uniform(-np.pi, np.pi, N),
                u1=np.full(N, 0.35), u2=np.full(N, 0.25),
                g=rng.uniform(0.2, 1.0, N))


def core_vs_reference(label: str, t_lc, obs, sigma: float, ns: int, N: int,
                      seed: int = 0):
    """Gate the shipped f32 core (lnL_planet, default backend, on the
    card) and its per-exposure mean deficit against f64 references.

    The f64 references run on the host's CPU backend: XLA's GPU compiler
    takes over ten minutes on the fused f64 Kepler + occultation-kernel
    reduction of the exact path (measured on an H100), while the CPU
    backend compiles it in seconds. The reference lnL is the Gaussian
    log-likelihood of the exact mean deficit, as lnL_planet forms it."""
    import jax
    import jax.numpy as jnp
    from triceratops_tpu.core.numerics import log_mean_exp
    from triceratops_tpu.ops import lightcurve as lc

    n_t = len(t_lc)
    d = _draws(N, seed)
    names = ("k", "P", "a_R", "inc", "e", "w", "u1", "u2")

    def deficit(dtype, exact, chunk):
        t_dev = jnp.asarray(np.asarray(t_lc, dtype))
        fn = jax.jit(lambda *a: lc._mean_deficit(
            t_dev, EXPTIME, *a, n_t, ns, exact))
        a = [jnp.asarray(np.asarray(d[n], dtype)) for n in names]
        return np.concatenate([
            np.asarray(fn(*[x[i:i + chunk] for x in a]), np.float64)
            for i in range(0, N, chunk)])

    chunk = lc.draw_chunk(n_t, ns)
    f32 = [jnp.asarray(np.asarray(d[n], np.float32)) for n in names + ("g",)]
    l32 = np.asarray(lc.lnL_planet(
        jnp.asarray(np.asarray(t_lc, np.float32)),
        jnp.asarray(np.asarray(obs, np.float32)), np.float32(sigma), *f32,
        jnp.ones((N,), bool), exptime=EXPTIME, n_t=n_t, ns=ns, chunk=chunk),
        np.float64)
    D32 = deficit(np.float32, False, chunk)
    ref_chunk = max(256, (1 << 22) // (n_t * ns))  # ~4M points per call
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        D64_fast = deficit(np.float64, False, ref_chunk)
        D64 = deficit(np.float64, True, ref_chunk)
    resid = np.asarray(obs, np.float64)[None, :] + d["g"][:, None] * D64
    l64 = (-0.5 * lc.LN2PI - np.log(sigma)
           - 0.5 * np.sum(resid * resid, axis=1) / sigma**2)
    z32 = log_mean_exp(l32, N_total=N)
    z64 = log_mean_exp(l64, N_total=N)

    dd_prec = float(np.abs(D32 - D64_fast).max())
    dd_exact = float(np.abs(D32 - D64).max())
    top = l64 > l64.max() - LNL_TOP_NATS
    dl = np.abs(l32[top] - l64[top])
    rel = np.abs(l32 - l64) / (np.abs(l64) + 1.0)
    dz = abs(z32 - z64)
    print(f"core {label}: N={N} n_t={n_t} ns={ns}: max|dD| vs f64 fast "
          f"{dd_prec:.3e} (gate {GATE_DD_PRECISION:g}), vs f64 exact "
          f"{dd_exact:.3e} (gate {GATE_DD_EXACT:g}); lnL over {top.sum()} "
          f"draws within {LNL_TOP_NATS:g} nats: p99 "
          f"{np.quantile(dl, 0.99):.3e} max {dl.max():.3e}; relative p99 "
          f"{np.quantile(rel, 0.99):.3e}; lnZ f32 {z32:.6f} f64 {z64:.6f} "
          f"|dlnZ| {dz:.3e}", flush=True)
    check(np.all(np.isfinite(l32)), f"{label}: non-finite f32 lnL")
    check(dd_prec <= GATE_DD_PRECISION, f"{label}: dD precision {dd_prec}")
    check(dd_exact <= GATE_DD_EXACT, f"{label}: dD vs exact {dd_exact}")
    check(np.quantile(dl, 0.99) < GATE_LNL_P99 and dl.max() < GATE_LNL_MAX,
          f"{label}: lnL p99 {np.quantile(dl, 0.99)} max {dl.max()}")
    check(np.quantile(rel, 0.99) < GATE_LNL_REL_P99,
          f"{label}: relative lnL p99 {np.quantile(rel, 0.99)}")
    check(dz < GATE_LNZ, f"{label}: |dlnZ| {dz}")


def core_phase(N: int = N_CORE, n_long: int = N_LONG,
               N_long: int = N_CORE_LONG):
    rng = np.random.default_rng(7)
    sigma = 4e-4
    t_short = np.linspace(-0.15, 0.15, 100)
    core_vs_reference("100-point", t_short, rng.normal(0, sigma, 100), sigma,
                      ns=20, N=N)
    t_long = np.sort(rng.uniform(-0.3, 0.3, n_long))
    core_vs_reference(f"{n_long}-point", t_long,
                      rng.normal(0, 2e-3, n_long), 2e-3, ns=1, N=N_long,
                      seed=1)


# ---------------------------------------------------------------------------
# --mesh: four cards against one
# ---------------------------------------------------------------------------

def mesh_phase(tmpdir: str, devices, N: int = N_MAIN, n_targets: int = 4):
    import jax
    from bench import build_fixtures
    from triceratops_tpu.parallel.sharding import (
        FULL_SCENARIOS, batch_fpp_full, make_mesh, prepare_target_batch)
    from triceratops_tpu.ops.lightcurve import draw_chunk

    stars, tri, t_lc, flux, sigma, P = build_fixtures(tmpdir)
    s = stars.iloc[0]
    rng = np.random.default_rng(3)
    targets = [dict(time=t_lc, flux=flux + rng.normal(0, sigma / 2, len(t_lc)),
                    sigma=sigma, P_orb=P, M_s=s["mass"], R_s=s["rad"],
                    Teff=s["Teff"], Z=0.0, plx=s["plx"], Tmag=s["Tmag"],
                    Jmag=s["Jmag"], Hmag=s["Hmag"], Kmag=s["Kmag"],
                    trilegal_fname=tri, key=jax.random.key(100 + i))
               for i in range(n_targets)]
    batch, n_t, has_cc = prepare_target_batch(targets)
    chunk = draw_chunk(n_t, 20)
    out = {}
    for shape in ((2, 2), (1, 1)):
        n_dev = shape[0] * shape[1]
        mesh = make_mesh(n_dev, n_target_shards=shape[0],
                         devices=devices[:n_dev])
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            fpp, nfpp, lnZ = batch_fpp_full(mesh, batch, N=N, n_t=n_t,
                                            ns=20, chunk=chunk,
                                            has_cc=has_cc)
            fpp, lnZ = np.asarray(fpp), np.asarray(lnZ)
            walls.append(time.perf_counter() - t0)
        out[shape] = (fpp, lnZ)
        peaks = [peak_bytes(d) for d in devices[:n_dev]]
        print(f"mesh {shape[0]}x{shape[1]}: {n_targets} targets x N={N}: "
              f"first call {walls[0]:.3f} s, second {walls[1]:.3f} s; "
              f"FPP {np.round(fpp, 6).tolist()}; peak_bytes_in_use per "
              f"device {peaks}", flush=True)
        check(np.all((fpp >= 0) & (fpp <= 1)), f"FPP {fpp}")
        check(np.all(np.isfinite(lnZ) | np.isneginf(lnZ)), f"lnZ {lnZ}")
        check(devices[0].platform == "cpu" or all(p > 0 for p in peaks),
              f"a mesh device held no arrays: {peaks}")
    # per-row rule of tests/test_sharding.py::test_mesh_invariance
    twin = np.array([r.endswith("x2P") for r in FULL_SCENARIOS])
    seb = np.array([r == "SEBx2P" for r in FULL_SCENARIOS])
    gate = np.where(seb, 3.0, np.where(twin, 2.0, 1.5))
    a, b = out[(2, 2)][1], out[(1, 1)][1]
    both_inf = np.isneginf(a) & np.isneginf(b)
    d = np.where(both_inf, 0.0, np.abs(a - b))
    deep = ((a < a.max(1, keepdims=True) - 5.0)
            & (b < b.max(1, keepdims=True) - 5.0))
    print(f"mesh: max |dlnZ| 2x2 vs 1x1 per scenario "
          f"{dict(zip(FULL_SCENARIOS, np.round(d.max(0), 4).tolist()))}",
          flush=True)
    check(np.all((d < gate) | deep), f"mesh lnZ disagreement: {d}")


def main(argv=None):
    # the f64 reference of phase 3 runs on the CPU backend beside the GPU
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)
    count = 4 if args.mesh else 1
    from bench import require_gpu

    devs = require_gpu(count)
    with tempfile.TemporaryDirectory() as tmpdir:
        if args.mesh:
            mesh_phase(tmpdir, devs[:count])
        else:
            main_path(tmpdir)
            core_phase()
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))


if __name__ == "__main__":
    main()
