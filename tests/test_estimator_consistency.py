"""Importance-sampled vs plain-rejection estimator consistency at the
FPP level: both are unbiased estimators of the same scenario evidences,
so full-pipeline FPPs must agree within joint Monte-Carlo noise."""

import numpy as np
import pandas as pd
import jax
import pytest

from triceratops_tpu import target
from fixtures import make_transit_lightcurve, make_trilegal_csv


@pytest.mark.slow
def test_is_vs_plain_fpp(tmp_path):
    tri = make_trilegal_csv(tmp_path / "tri.csv", n_stars=400,
                            Tmag_target=10.0)
    stars = pd.DataFrame([dict(
        ID="1000", Tmag=10.0, Jmag=9.3, Hmag=9.1, Kmag=9.0, ra=120.0,
        dec=-30.0, mass=1.0, rad=1.0, Teff=5800.0, plx=20.0,
        **{"sep (arcsec)": 0.0, "PA (E of N)": 0.0})])
    time, flux, sigma, depth = make_transit_lightcurve(
        n_t=60, rp_re=9.0, sigma=4e-4, seed=7)

    def run(importance, N, key):
        t = target.from_stars(stars, ID=1000, sectors=[1],
                              trilegal_fname=str(tri))
        t.calc_depths(tdepth=depth)
        t.calc_probs(time, flux, sigma, P_orb=3.0, N=N, nsamples=2,
                     verbose=0, key=jax.random.key(key),
                     importance_sampling=importance)
        return t.FPP, np.array(t.lnZ)

    # IS at modest N has the effective sample size of plain at ~20x N;
    # compare IS(N=20k) against plain(N=200k)
    fpp_is, lnZ_is = run(True, 20000, 0)
    fpp_pl, lnZ_pl = run(False, 200000, 1)
    # the finite-evidence scenarios must agree to within a few nats
    both = np.isfinite(lnZ_is) & np.isfinite(lnZ_pl)
    assert both.sum() >= 6
    d = np.abs(lnZ_is[both] - lnZ_pl[both])
    assert np.median(d) < 3.0, (lnZ_is[both], lnZ_pl[both])
    # FPPs on the same order
    assert (fpp_is < 0.2) == (fpp_pl < 0.2)


def test_is_vs_plain_dominant_lnZ_tight():
    """Multi-key mean lnZ of the dominant (TP)
    scenario from the IS estimator agrees with plain rejection to well
    under 0.3 nats (the full 20-key x 1e6/1e7-draw version lives in
    bench_scripts/bias_audit.py; measured there and on CPU at these
    shapes: |dmean| ~ 0.002 nats)."""
    from triceratops_tpu.scenarios.api import lnZ_TTP
    from fixtures import make_transit_lightcurve

    time, flux, sigma, _ = make_transit_lightcurve(
        n_t=60, rp_re=3.0, sigma=5e-4, seed=3)
    K = 4

    def mean_lnZ(importance, N):
        vals = [float(lnZ_TTP(time, flux, sigma, 3.0, 1.0, 1.0, 5800.0,
                              0.0, N=N, nsamples=2,
                              key=jax.random.key(60 + k),
                              importance_sampling=importance)["lnZ"])
                for k in range(K)]
        return np.mean(vals), np.std(vals, ddof=1) / np.sqrt(K)

    m_is, se_is = mean_lnZ(True, 100_000)
    m_pl, se_pl = mean_lnZ(False, 400_000)
    d = abs(m_is - m_pl)
    assert d < 0.3, (m_is, m_pl, se_is, se_pl)
    assert d < max(0.1, 4 * (se_is + se_pl)), (m_is, m_pl, se_is, se_pl)
