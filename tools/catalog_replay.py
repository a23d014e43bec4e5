"""Catalog replay driver: batch FPP vetting over many TOIs.

The practical form of BASELINE.json configs[4] ("batch vetting sweep:
384-TOI catalog replay at 1M draws/scenario"): every target reuses the
same compiled scenario programs (shapes are fixed by the shared light-
curve binning and draw count), so per-target cost after the first is the
steady-state FPP wall time. Results are written as a csv alongside the
published-catalog columns for comparison (populations/catalogs.py).

Two execution modes:

* serial (``--serial``; the default on a single device) — the frontend
  path: one ``target.calc_probs`` per TOI.
* sharded (``--sharded``; the default with >1 device) — targets stream
  in fixed-size batches through ``parallel.sharding.batch_fpp_full`` on
  a ('targets', 'draws') ``jax.sharding.Mesh``, covering the full
  15-scenario taxonomy; per-target reductions are chip-local and the
  only collective is the per-scenario evidence logsumexp (SURVEY.md
  section 2.4 per-target axis). The mesh path pays off when the targets
  axis actually spans devices.

With only synthetic data available offline, the sweep runs on
synthesized light curves drawn from the catalog's (Rp, Porb) rows; swap
``build_target`` for real per-TOI field queries + folded light curves to
reproduce the paper tables.

Usage:
    python tools/catalog_replay.py [n_targets] [N_draws] [--serial|--sharded]
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/catalog_replay.py 16 65536   # 8-way CPU mesh demo
"""

import os
import sys
import time as _time

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from functools import lru_cache


@lru_cache(maxsize=4)
def _lc_builder(n_t):
    """Jitted synthetic-transit deficit builder (one compiled program
    per curve length instead of many eager dispatches per target)."""
    import jax
    import jax.numpy as jnp
    from triceratops_tpu.core.kepler import projected_z
    from triceratops_tpu.ops.occult import occult_quad_deficit

    @jax.jit
    def build(time, P, a_R, k):
        z, front = projected_z(time, 0.0, P, a_R,
                               jnp.deg2rad(89.3), 0.0, 0.0)
        D = occult_quad_deficit(k, z, jnp.float32(0.35), jnp.float32(0.25))
        return D * front

    return build


def _synth_lc(row, n_t=100, sigma=4e-4):
    """Synthetic folded light curve from a catalog (Rp, Porb) row."""
    import jax.numpy as jnp
    from triceratops_tpu.constants import G, MSUN, RSUN, REARTH

    P = float(np.clip(row["Porb"], 0.8, 20.0))
    rp = float(np.clip(row["Rp"], 1.0, 16.0))
    time = np.linspace(-0.15, 0.15, n_t)
    a = ((G * MSUN) / (4 * np.pi**2) * (P * 86400) ** 2) ** (1 / 3)
    D = np.asarray(_lc_builder(n_t)(
        jnp.asarray(time, jnp.float32), jnp.float32(P),
        jnp.float32(a / RSUN), jnp.float32(rp * REARTH / RSUN)))
    rng = np.random.default_rng(int(row["TOI"] * 100) % 2**31)
    return time, 1.0 - D + rng.normal(0, sigma, n_t), sigma, P, float(D.max())


def build_target(row, trilegal, n_t=100, sigma=4e-4):
    from triceratops_tpu import target

    time, flux, sigma, P, depth = _synth_lc(row, n_t=n_t, sigma=sigma)
    stars = pd.DataFrame([dict(
        ID=str(int(row["TICID"])), Tmag=10.0, Jmag=9.3, Hmag=9.1,
        Kmag=9.0, ra=90.0, dec=-60.0, mass=1.0, rad=1.0, Teff=5800.0,
        plx=10.0, **{"sep (arcsec)": 0.0, "PA (E of N)": 0.0})])
    t = target.from_stars(stars, ID=int(row["TICID"]), sectors=[1],
                          trilegal_fname=trilegal)
    t.calc_depths(tdepth=depth)
    return t, time, flux, sigma, P


def main_sharded(n_targets=8, N=1000000, out_csv="/tmp/catalog_replay.csv",
                 n_t=100, ns=20, batch_B=8):
    """Mesh-sharded replay: TOIs stream through batch_fpp_full in
    fixed-size batches (shapes repeat, so the traced/compiled step is
    reused — only the first batch pays trace+compile)."""
    import jax
    from triceratops_tpu.parallel.sharding import (
        make_mesh, batch_fpp_full, prepare_target_batch)
    from triceratops_tpu.populations.catalogs import vetting_catalog
    from triceratops_tpu.populations.synthetic import make_synthetic_trilegal

    cat = vetting_catalog().sample(n_targets, random_state=0)
    trilegal = make_synthetic_trilegal("/tmp/replay_trilegal.csv",
                                       Tmag_target=10.0, seed=1)
    n_dev = len(jax.devices())
    batch_B = min(batch_B, n_targets)
    nts = 1
    for cand in range(min(n_dev, batch_B), 0, -1):
        if n_dev % cand == 0 and batch_B % cand == 0:
            nts = cand
            break
    mesh = make_mesh(n_dev, n_target_shards=nts)
    N = -(-N // mesh.shape["draws"]) * mesh.shape["draws"]
    print(f"mesh {dict(mesh.shape)}; {n_targets} targets x {N} draws, "
          f"batches of {batch_B}")

    all_targets = []
    cat_rows = list(cat.iterrows())
    for i, (_, row) in enumerate(cat_rows):
        time, flux, sigma, P, _depth = _synth_lc(row, n_t=n_t)
        all_targets.append(dict(
            time=time, flux=flux, sigma=sigma, P_orb=P, M_s=1.0, R_s=1.0,
            Teff=5800.0, Z=0.0, plx=10.0, Tmag=10.0, Jmag=9.3, Hmag=9.1,
            Kmag=9.0, trilegal_fname=trilegal, key=jax.random.key(i)))

    from triceratops_tpu.ops.lightcurve import draw_chunk

    rows = []
    t_start = _time.time()
    batch_walls = []
    pull_times = []

    def record(start, pad, fpp, nfpp, t0):
        # materializing here blocks on the device result; under the
        # pipeline the honest per-batch cost is the pull-to-pull
        # interval (prep of the next batch is already enqueued)
        fpp, nfpp = np.asarray(fpp), np.asarray(nfpp)
        done = _time.time()
        wall = done - (pull_times[-1] if pull_times else t0)
        pull_times.append(done)
        batch_walls.append(wall)
        for j in range(batch_B - pad):
            _, row = cat_rows[start + j]
            rows.append(dict(TOI=row["TOI"], TICID=row["TICID"],
                             Rp=row["Rp"], Porb=row["Porb"],
                             FPP=float(fpp[j]), NFPP=float(nfpp[j]),
                             FPP_paper=row["FPP"], NFPP_paper=row["NFPP"],
                             Classification=row["Classification"]))
        print(f"  batch {start // batch_B}: {wall:.1f}s "
              f"({wall / batch_B:.2f}s/target)")

    # software pipeline: prep + enqueue batch i+1 BEFORE blocking on
    # batch i's results, so host-side prep/transfer rides under device
    # compute (dispatch is fully async; the result pull is the only
    # blocking point)
    pending = None
    for start in range(0, n_targets, batch_B):
        group = all_targets[start:start + batch_B]
        pad = batch_B - len(group)
        group = group + [dict(group[-1]) for _ in range(pad)]
        batch, _, has_cc = prepare_target_batch(group)
        t0 = _time.time()
        fpp, nfpp, _lnZ = batch_fpp_full(mesh, batch, N=N, n_t=n_t, ns=ns,
                                         chunk=draw_chunk(n_t, ns),
                                         has_cc=has_cc)
        if pending is not None:
            record(*pending)
        pending = (start, pad, fpp, nfpp, t0)
    record(*pending)
    total = _time.time() - t_start
    pd.DataFrame(rows).to_csv(out_csv, index=False)
    steady = (np.mean(batch_walls[1:]) / batch_B
              if len(batch_walls) > 1 else batch_walls[0] / batch_B)
    print(f"wrote {out_csv}; {n_targets} targets in {total:.1f}s "
          f"(steady-state {steady:.2f}s/target)")


def main(n_targets=8, N=1000000, out_csv="/tmp/catalog_replay.csv"):
    import jax
    from triceratops_tpu.populations.catalogs import vetting_catalog
    from triceratops_tpu.populations.synthetic import make_synthetic_trilegal

    cat = vetting_catalog().sample(n_targets, random_state=0)
    trilegal = make_synthetic_trilegal("/tmp/replay_trilegal.csv",
                                       Tmag_target=10.0, seed=1)
    rows = []
    t_start = _time.time()
    for i, (_, row) in enumerate(cat.iterrows()):
        t, time, flux, sigma, P = build_target(row, trilegal)
        t0 = _time.time()
        t.calc_probs(time, flux, sigma, P_orb=P, N=N, nsamples=20,
                     verbose=0, key=jax.random.key(i))
        wall = _time.time() - t0
        rows.append(dict(TOI=row["TOI"], TICID=row["TICID"],
                         Rp=row["Rp"], Porb=row["Porb"],
                         FPP=t.FPP, NFPP=t.NFPP,
                         FPP_paper=row["FPP"], NFPP_paper=row["NFPP"],
                         Classification=row["Classification"],
                         wall_s=round(wall, 2)))
        print(f"[{i+1}/{n_targets}] TOI {row['TOI']}: FPP={t.FPP:.3g} "
              f"({wall:.1f}s)")
    df = pd.DataFrame(rows)
    df.to_csv(out_csv, index=False)
    total = _time.time() - t_start
    print(f"\nwrote {out_csv}; {n_targets} targets in {total:.0f}s "
          f"({total/n_targets:.1f}s/target incl. first compile)")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if len(args) > 0 else 8
    N = int(args[1]) if len(args) > 1 else 1000000
    if "--serial" in sys.argv:
        main(n, N)
    elif "--sharded" in sys.argv:
        main_sharded(n, N)
    else:
        import jax
        if len(jax.devices()) > 1:
            main_sharded(n, N)
        else:
            main(n, N)
