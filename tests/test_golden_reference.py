"""Golden validation against the reference's bundled example data.

Reads the reference light curves at runtime from /root/reference (never
copied into this repo); skipped when that mount is absent. Star
parameters are the published TIC values for the example targets.

The FPP anchors (BASELINE.md) are Monte-Carlo noisy — the reference's own
20-run spread at TOI-465 is +/-0.058 — so assertions are order-of-
magnitude/statistical, not exact.
"""

import os

import numpy as np
import pandas as pd
import pytest
import jax

REF = "/root/reference/examples"

# the Kepler-10b case runs whenever the reference mount exists (the one
# always-on real-data anchor, so the CPU suite is not purely
# self-generated); the rest stays behind RUN_GOLDEN (heavy; run on the
# GPU via bench_scripts/validate_golden.py)
pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF),
    reason="reference examples not mounted")


def _target_offline(stars_rows, trilegal, ID):
    from triceratops_tpu import target
    return target.from_stars(pd.DataFrame(stars_rows), ID=ID, sectors=[1],
                             trilegal_fname=trilegal)


@pytest.fixture(scope="module")
def trilegal(tmp_path_factory):
    from fixtures import make_trilegal_csv
    p = tmp_path_factory.mktemp("tri3") / "trilegal.csv"
    return make_trilegal_csv(p, Tmag_target=10.0, n_stars=2000)


class TestKepler10b:
    """Kepler-10b: published FPP 8.4e-6 (BASELINE.md; reference
    kepler_example.ipynb cell 12). With a synthetic TRILEGAL table the
    background scenarios differ slightly, but the verdict (planet,
    FPP << 0.1) must reproduce."""

    def test_low_fpp(self, trilegal):
        lc = pd.read_csv(os.path.join(REF, "Kepler10b_lightcurve.csv"),
                         header=None)
        time = lc[0].values
        flux = lc[1].values
        sigma = float(np.mean(lc[2].values))
        # Kepler-10 published stellar parameters (Batalha et al. 2011)
        stars = [dict(ID="11904151", Tmag=10.96, Jmag=9.889, Hmag=9.563,
                      Kmag=9.496, ra=285.679, dec=50.241, mass=0.91,
                      rad=1.065, Teff=5708.0, plx=5.88,
                      **{"sep (arcsec)": 0.0, "PA (E of N)": 0.0})]
        t = _target_offline(stars, trilegal, ID=11904151)
        t.mission = "Kepler"
        t.calc_depths(tdepth=1.52e-4)
        # importance sampling makes N=100k comparable to the reference's
        # 1e6 rejection draws in effective sample size; nsamples=2 keeps
        # the CPU budget (GL-2 vs GL-4 exposure nodes move lnZ < 3e-4)
        # the reference notebook keeps the default 2-min exptime (the
        # folded curve is short-cadence; kepler_example.ipynb cell 10)
        t.calc_probs(time, flux, sigma, P_orb=0.837, N=100000, nsamples=2,
                     verbose=0, key=jax.random.key(0))
        assert np.isfinite(t.FPP)
        # measured FPP at this config is ~4e-6 (N=1e6 value 3.8e-6,
        # published 8.4e-6): a 1e-2 gate catches a 100x regression while
        # leaving ~3 orders of MC/background headroom
        assert t.FPP < 1e-2, f"Kepler-10b FPP={t.FPP} (expected ~4e-6)"
        assert t.NFPP == 0.0
        p = t.probs["prob"].values
        planet_mass = p[0] + p[3] + p[9]
        assert planet_mass > 0.98, \
            f"P(TP)+P(PTP)+P(DTP)={planet_mass} (expected > 0.98)"
