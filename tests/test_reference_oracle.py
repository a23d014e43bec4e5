"""Reference-formula oracle tests.

A literal NumPy-float64 transcription of the reference's lnZ_TTP /
lnZ_TEB evidence chains — orbit solve, transit-probability and collision
masks, dilution algebra, secondary-eclipse veto, per-draw normalization,
log-mean-exp evidence (reference marginal_likelihoods.py:39-383,
likelihoods.py:302-587) — evaluated at matched draws, with the transit
kernel supplied by the independent adaptive-quadrature anchor
``occult_quad_deficit_reference``. The framework cores must reproduce
per-draw lnL to within the documented kernel-anchor difference
(<~1e-3 in lnL at these tolerances; a wrong dilution factor, mask, or
normalization term would shift lnL by O(1)), and the engine's sampler
geometry must reproduce the masks draw-for-draw.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from triceratops_tpu.constants import G, MSUN, RSUN, REARTH
from triceratops_tpu.ops.occult import occult_quad_deficit_reference
from triceratops_tpu.ops.lightcurve import lnL_planet, lnL_eb, SEC_GRID
from triceratops_tpu.populations.stellar import stellar_relations, flux_relation
from triceratops_tpu.scenarios import engine as eng

LN2PI = np.log(2 * np.pi)

# --------------------------------------------------------------------------
# Oracle: independent NumPy transcription of the reference formula chain
# --------------------------------------------------------------------------


def _oracle_kepler_E(M, e, iters=80):
    E = np.where(e < 0.8, M, np.pi * np.sign(M) * np.ones_like(M))
    E = np.array(E, float)
    for _ in range(iters):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def _oracle_z(t, P, a_R, inc_deg, e, argp_deg):
    """Sky-projected separation, PyTransit conventions: t0 = 0 at
    inferior conjunction, w = (90 - argp) deg (reference
    likelihoods.py:344-349)."""
    w = np.deg2rad(90.0 - argp_deg)
    inc = np.deg2rad(inc_deg)
    nu_tc = np.pi / 2.0 - w
    E_tc = 2.0 * np.arctan2(np.sqrt(1.0 - e) * np.sin(nu_tc / 2.0),
                            np.sqrt(1.0 + e) * np.cos(nu_tc / 2.0))
    M_tc = E_tc - e * np.sin(E_tc)
    M = M_tc + 2.0 * np.pi * t / P
    M = np.mod(M + np.pi, 2.0 * np.pi) - np.pi
    E = _oracle_kepler_E(M, e)
    nu = 2.0 * np.arctan2(np.sqrt(1.0 + e) * np.sin(E / 2.0),
                          np.sqrt(1.0 - e) * np.cos(E / 2.0))
    r = a_R * (1.0 - e * np.cos(E))
    swnu = np.sin(w + nu)
    z = r * np.sqrt(np.maximum(1.0 - np.sin(inc) ** 2 * swnu**2, 0.0))
    return z, swnu > 0.0


def _oracle_deficit_curve(time, exptime, ns, k, P, a_R, inc_deg, e,
                          argp_deg):
    """Exposure-averaged occultation deficit on the data grid (PyTransit
    supersampling: ns midpoints per exposure, ref likelihoods.py:61)."""
    if ns > 1:
        offs = exptime * ((np.arange(ns) + 0.5) / ns - 0.5)
        t_ss = (time[:, None] + offs[None, :]).reshape(-1)
    else:
        t_ss = time
    z, front = _oracle_z(t_ss, P, a_R, inc_deg, e, argp_deg)
    D = np.array([occult_quad_deficit_reference(k, zi, _U1, _U2)
                  if f else 0.0 for zi, f in zip(z, front)])
    if ns > 1:
        D = D.reshape(len(time), ns).mean(axis=1)
    return D


def _oracle_lnL_TP(time, flux, sigma, exptime, ns, rp, P, a_cm, R_s,
                   inc_deg, e, argp_deg, F_comp, companion_is_host):
    """Reference lnL chain for one TP draw (likelihoods.py:302-487):
    model flux + dilution, chi^2, -0.5 ln2pi - ln sigma - 0.5 chi^2."""
    k = rp * REARTH / (R_s * RSUN)
    a_R = a_cm / (R_s * RSUN)
    D = _oracle_deficit_curve(time, exptime, ns, k, P, a_R, inc_deg, e,
                              argp_deg)
    model = 1.0 - D
    F_dilute = (1.0 / F_comp) if companion_is_host else F_comp
    model = (model + F_dilute) / (1.0 + F_dilute)
    chi2 = np.sum((flux - model) ** 2 / sigma**2)
    return -0.5 * LN2PI - np.log(sigma) - 0.5 * chi2


def _oracle_lnL_EB(time, flux, sigma, exptime, ns, R_EB, fluxratio_EB,
                   P, a_cm, R_s, inc_deg, e, argp_deg, F_comp,
                   companion_is_host, apply_veto):
    """Reference lnL chain for one EB draw (likelihoods.py:361-587):
    primary on the data grid, secondary-depth scan on the fixed 25-point
    grid with w+180 deg and k -> 1/k, dilution chains, 1.5 sigma veto."""
    k = R_EB / R_s
    if (k - 1.0) < 1e-6:           # batch-path near-unity adjustment
        k = k * 0.999              # (reference likelihoods.py:405-406)
    ksec = R_s / R_EB
    if (ksec - 1.0) < 1e-6:
        ksec = ksec * 0.999
    a_R = a_cm / (R_s * RSUN)
    D = _oracle_deficit_curve(time, exptime, ns, k, P, a_R, inc_deg, e,
                              argp_deg)
    model = 1.0 - D
    zs, fronts = _oracle_z(np.asarray(SEC_GRID), P, a_R, inc_deg, e,
                           argp_deg + 180.0)
    Dsec = np.array([occult_quad_deficit_reference(ksec, zi, _U1, _U2)
                     if f else 0.0 for zi, f in zip(zs, fronts)])
    sec_flux = 1.0 - np.max(Dsec)
    F_EB = fluxratio_EB / (1.0 - fluxratio_EB)
    if companion_is_host:
        model = (model + F_EB / F_comp) / (1.0 + F_EB / F_comp)
        sec_flux = (sec_flux + F_comp / F_EB) / (1.0 + F_comp / F_EB)
        F_dilute = 1.0 / (F_comp + F_EB)
    else:
        model = (model + F_EB) / (1.0 + F_EB)
        sec_flux = (sec_flux + 1.0 / F_EB) / (1.0 + 1.0 / F_EB)
        F_dilute = F_comp / (1.0 + F_EB)
    model = (model + F_dilute) / (1.0 + F_dilute)
    secdepth = 1.0 - (sec_flux + F_dilute) / (1.0 + F_dilute)
    if apply_veto and secdepth >= 1.5 * sigma:
        return -np.inf             # lnL_EB_p returns +inf -> outer -inf
    chi2 = np.sum((flux - model) ** 2 / sigma**2)
    return -0.5 * LN2PI - np.log(sigma) - 0.5 * chi2


def _oracle_log_mean_exp(lnL, N):
    finite = np.isfinite(lnL)
    if not finite.any():
        return -np.inf
    m = lnL[finite].max()
    return m + np.log(np.exp(lnL[finite] - m).sum()) - np.log(N)


# shared LDC for the kernel comparisons
_U1, _U2 = 0.38, 0.24

# --------------------------------------------------------------------------
# Shared synthetic observation (any fixed data works for parity)
# --------------------------------------------------------------------------

N_T, NS, EXPTIME = 24, 2, 0.00139
SIGMA = 3e-3
TIME = np.linspace(-0.11, 0.11, N_T)
_rng = np.random.default_rng(7)
FLUX = 1.0 + _rng.normal(0, SIGMA, N_T)
FLUX[8:16] -= 0.004  # a dip so chi^2 actually discriminates


def _core_args(time=TIME, flux=FLUX):
    t_dev = jnp.asarray(time, jnp.float64)
    obs_dev = jnp.asarray(flux - 1.0, jnp.float64)
    return t_dev, obs_dev


class TestPlanetCoreOracle:
    """Framework lnL_planet vs the transcribed reference TP chain."""

    def _draws(self, N=48, seed=3):
        rng = np.random.default_rng(seed)
        M_s, R_s = 1.0, 1.0
        P = np.full(N, 3.0)
        rps = rng.uniform(1.0, 16.0, N)
        eccs = rng.uniform(0.0, 0.9, N)
        argps = rng.uniform(0.0, 360.0, N)
        a = ((G * M_s * MSUN) / (4 * np.pi**2) * (P * 86400.0) ** 2) ** (1 / 3)
        e_corr = (1 + eccs * np.sin(np.deg2rad(argps))) / (1 - eccs**2)
        Ptra = (rps * REARTH + R_s * RSUN) / a * e_corr
        coll = (rps * REARTH + R_s * RSUN) > a * (1 - eccs)
        # inclinations straddling inc_min so the mask has both branches
        inc_min = np.where(Ptra <= 1.0, np.degrees(np.arccos(np.minimum(Ptra, 1.0))), 90.0)
        incs = np.clip(inc_min + rng.uniform(-0.4, 0.4, N), 0.0, 90.0)
        mask = (Ptra <= 1.0) & (incs >= inc_min) & ~coll
        return dict(M_s=M_s, R_s=R_s, P=P, rps=rps, eccs=eccs, argps=argps,
                    a=a, incs=incs, mask=mask)

    @pytest.mark.parametrize("companion_is_host,F_comp", [
        (False, 0.0), (False, 0.45), (True, 0.6),
    ])
    def test_per_draw_lnL_and_lnZ(self, companion_is_host, F_comp):
        d = self._draws()
        N = len(d["P"])
        lnL_oracle = np.full(N, -np.inf)
        for i in range(N):
            if not d["mask"][i]:
                continue
            lnL_oracle[i] = _oracle_lnL_TP(
                TIME, FLUX, SIGMA, EXPTIME, NS, d["rps"][i], d["P"][i],
                d["a"][i], d["R_s"], d["incs"][i], d["eccs"][i],
                d["argps"][i], F_comp, companion_is_host)

        t_dev, obs_dev = _core_args()
        f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
        if F_comp == 0.0:
            g = np.ones(N)
        elif companion_is_host:
            g = np.full(N, 1.0 / (1.0 + 1.0 / F_comp))
        else:
            g = np.full(N, 1.0 / (1.0 + F_comp))
        lnL_mine = np.asarray(lnL_planet(
            t_dev, obs_dev, SIGMA,
            f64(d["rps"] * REARTH / (d["R_s"] * RSUN)),
            f64(d["P"]), f64(d["a"] / (d["R_s"] * RSUN)),
            f64(np.deg2rad(d["incs"])), f64(d["eccs"]),
            f64(np.deg2rad(90.0 - d["argps"])),
            f64(np.full(N, _U1)), f64(np.full(N, _U2)), f64(g),
            jnp.asarray(d["mask"]),
            exptime=EXPTIME, n_t=N_T, ns=NS, chunk=16, exact=True))

        assert np.array_equal(np.isfinite(lnL_mine), d["mask"])
        m = d["mask"]
        assert m.sum() > 10  # the comparison is non-trivial
        np.testing.assert_allclose(lnL_mine[m], lnL_oracle[m], atol=5e-3,
                                   rtol=0)
        lnZ_o = _oracle_log_mean_exp(lnL_oracle, N)
        lnZ_m = _oracle_log_mean_exp(lnL_mine, N)
        assert abs(lnZ_o - lnZ_m) < 5e-3

    def test_fast_path_matches_oracle_loosely(self):
        """The production (Chebyshev + GL) path agrees with the
        transcribed chain to kernel-proxy tolerance."""
        d = self._draws()
        N = len(d["P"])
        lnL_oracle = np.full(N, -np.inf)
        for i in range(N):
            if d["mask"][i]:
                lnL_oracle[i] = _oracle_lnL_TP(
                    TIME, FLUX, SIGMA, EXPTIME, NS, d["rps"][i], d["P"][i],
                    d["a"][i], d["R_s"], d["incs"][i], d["eccs"][i],
                    d["argps"][i], 0.0, False)
        t_dev, obs_dev = _core_args()
        f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
        lnL_fast = np.asarray(lnL_planet(
            t_dev, obs_dev, SIGMA,
            f64(d["rps"] * REARTH / (d["R_s"] * RSUN)),
            f64(d["P"]), f64(d["a"] / (d["R_s"] * RSUN)),
            f64(np.deg2rad(d["incs"])), f64(d["eccs"]),
            f64(np.deg2rad(90.0 - d["argps"])),
            f64(np.full(N, _U1)), f64(np.full(N, _U2)), f64(np.ones(N)),
            jnp.asarray(d["mask"]),
            exptime=EXPTIME, n_t=N_T, ns=NS, chunk=16, exact=False))
        m = d["mask"]
        np.testing.assert_allclose(lnL_fast[m], lnL_oracle[m], atol=0.05,
                                   rtol=0)


class TestEBCoreOracle:
    """Framework lnL_eb vs the transcribed reference TEB/PEB/SEB chain."""

    def _draws(self, N=32, seed=5):
        rng = np.random.default_rng(seed)
        M_s, R_s, Teff = 1.0, 1.0, 5800.0
        P = np.full(N, 3.0)
        qs = rng.uniform(0.1, 1.0, N)
        eccs = rng.uniform(0.0, 0.6, N)
        argps = rng.uniform(0.0, 360.0, N)
        masses = qs * M_s
        radii, _ = stellar_relations(masses, np.full(N, R_s),
                                     np.full(N, Teff))
        fr = flux_relation(masses)
        fluxratios = fr / (fr + flux_relation(np.array([M_s])))
        a = ((G * (M_s + masses) * MSUN) / (4 * np.pi**2)
             * (P * 86400.0) ** 2) ** (1 / 3)
        a_twin = ((G * (M_s + masses) * MSUN) / (4 * np.pi**2)
                  * (2 * P * 86400.0) ** 2) ** (1 / 3)
        e_corr = (1 + eccs * np.sin(np.deg2rad(argps))) / (1 - eccs**2)
        Ptra = (radii * RSUN + R_s * RSUN) / a * e_corr
        Ptra_twin = (radii * RSUN + R_s * RSUN) / a_twin * e_corr
        coll = (radii * RSUN + R_s * RSUN) > a * (1 - eccs)
        coll_twin = (2 * R_s * RSUN) > a_twin * (1 - eccs)
        inc_min = np.where(Ptra <= 1.0,
                           np.degrees(np.arccos(np.minimum(Ptra, 1.0))), 90.0)
        incs = np.clip(inc_min + rng.uniform(-1.0, 1.0, N), 0.0, 90.0)
        inc_min_t = np.where(Ptra_twin <= 1.0,
                             np.degrees(np.arccos(np.minimum(Ptra_twin, 1.0))), 90.0)
        mask = (Ptra <= 1.0) & (incs >= inc_min) & ~coll & (qs < 0.95)
        mask_twin = ((Ptra_twin <= 1.0) & (incs >= inc_min_t) & ~coll_twin
                     & (qs >= 0.95))
        return dict(M_s=M_s, R_s=R_s, P=P, qs=qs, eccs=eccs, argps=argps,
                    masses=masses, radii=radii, fluxratios=fluxratios,
                    a=a, a_twin=a_twin, incs=incs, mask=mask,
                    mask_twin=mask_twin)

    def _mine(self, d, P, a, mask, F_comp, companion_is_host, apply_veto):
        N = len(d["P"])
        R_s = d["R_s"]
        k = d["radii"] / R_s
        k = np.where((k - 1.0) < 1e-6, k * 0.999, k)
        ksec = R_s / d["radii"]
        ksec = np.where((ksec - 1.0) < 1e-6, ksec * 0.999, ksec)
        F_EB = d["fluxratios"] / (1.0 - d["fluxratios"])
        if companion_is_host:
            x1, x2, y1 = F_EB / F_comp, 1.0 / (F_comp + F_EB), F_comp / F_EB
        else:
            x1, x2, y1 = F_EB, F_comp / (1.0 + F_EB), 1.0 / F_EB
        g_pri = 1.0 / ((1.0 + x1) * (1.0 + x2))
        g_sec = 1.0 / ((1.0 + y1) * (1.0 + x2))
        t_dev, obs_dev = _core_args()
        f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
        return np.asarray(lnL_eb(
            t_dev, obs_dev, SIGMA, f64(k), f64(ksec), f64(P),
            f64(a / (R_s * RSUN)), f64(np.deg2rad(d["incs"])),
            f64(d["eccs"]), f64(np.deg2rad(90.0 - d["argps"])),
            f64(np.full(N, _U1)), f64(np.full(N, _U2)),
            f64(g_pri), f64(g_sec), jnp.asarray(mask),
            exptime=EXPTIME, n_t=N_T, ns=NS, chunk=16,
            apply_veto=apply_veto, exact=True))

    @pytest.mark.parametrize("companion_is_host,F_comp", [
        (False, 0.0), (False, 0.35), (True, 0.5),
    ])
    def test_normal_branch_with_veto(self, companion_is_host, F_comp):
        d = self._draws()
        N = len(d["P"])
        lnL_oracle = np.full(N, -np.inf)
        for i in range(N):
            if not d["mask"][i]:
                continue
            lnL_oracle[i] = _oracle_lnL_EB(
                TIME, FLUX, SIGMA, EXPTIME, NS, d["radii"][i],
                d["fluxratios"][i], d["P"][i], d["a"][i], d["R_s"],
                d["incs"][i], d["eccs"][i], d["argps"][i], F_comp,
                companion_is_host, apply_veto=True)
        lnL_mine = self._mine(d, d["P"], d["a"], d["mask"], F_comp,
                              companion_is_host, apply_veto=True)
        # the 1.5 sigma veto decisions must agree draw-for-draw
        assert np.array_equal(np.isfinite(lnL_mine),
                              np.isfinite(lnL_oracle))
        m = np.isfinite(lnL_oracle)
        assert m.sum() > 5
        np.testing.assert_allclose(lnL_mine[m], lnL_oracle[m], atol=5e-3,
                                   rtol=0)
        assert abs(_oracle_log_mean_exp(lnL_mine, N)
                   - _oracle_log_mean_exp(lnL_oracle, N)) < 5e-3

    def test_twin_branch_no_veto(self):
        d = self._draws(N=48, seed=11)
        # force the twin branch populated: q >= 0.95 for half the draws
        d["qs"][::2] = np.random.default_rng(1).uniform(0.95, 1.0,
                                                        len(d["qs"][::2]))
        d = self._redraw_from_q(d)
        N = len(d["P"])
        lnL_oracle = np.full(N, -np.inf)
        for i in range(N):
            if not d["mask_twin"][i]:
                continue
            lnL_oracle[i] = _oracle_lnL_EB(
                TIME, FLUX, SIGMA, EXPTIME, NS, d["radii"][i],
                d["fluxratios"][i], 2 * d["P"][i], d["a_twin"][i],
                d["R_s"], d["incs"][i], d["eccs"][i], d["argps"][i],
                0.0, False, apply_veto=False)
        lnL_mine = self._mine(d, 2 * d["P"], d["a_twin"], d["mask_twin"],
                              0.0, False, apply_veto=False)
        assert np.array_equal(np.isfinite(lnL_mine), d["mask_twin"])
        m = d["mask_twin"]
        assert m.sum() > 5
        np.testing.assert_allclose(lnL_mine[m], lnL_oracle[m], atol=5e-3,
                                   rtol=0)

    def _redraw_from_q(self, d):
        """Recompute the q-dependent chain after editing qs."""
        N = len(d["P"])
        M_s, R_s = d["M_s"], d["R_s"]
        d["masses"] = d["qs"] * M_s
        d["radii"], _ = stellar_relations(d["masses"], np.full(N, R_s),
                                          np.full(N, 5800.0))
        fr = flux_relation(d["masses"])
        d["fluxratios"] = fr / (fr + flux_relation(np.array([M_s])))
        d["a"] = ((G * (M_s + d["masses"]) * MSUN) / (4 * np.pi**2)
                  * (d["P"] * 86400.0) ** 2) ** (1 / 3)
        d["a_twin"] = ((G * (M_s + d["masses"]) * MSUN) / (4 * np.pi**2)
                       * (2 * d["P"] * 86400.0) ** 2) ** (1 / 3)
        e_corr = (1 + d["eccs"] * np.sin(np.deg2rad(d["argps"]))) / (1 - d["eccs"]**2)
        Ptra_twin = (d["radii"] * RSUN + R_s * RSUN) / d["a_twin"] * e_corr
        coll_twin = (2 * R_s * RSUN) > d["a_twin"] * (1 - d["eccs"])
        inc_min_t = np.where(
            Ptra_twin <= 1.0,
            np.degrees(np.arccos(np.minimum(Ptra_twin, 1.0))), 90.0)
        # put inclinations near the twin threshold so some transit
        rng = np.random.default_rng(2)
        d["incs"] = np.clip(inc_min_t + rng.uniform(-0.5, 0.5, N), 0.0, 90.0)
        d["mask_twin"] = ((Ptra_twin <= 1.0) & (d["incs"] >= inc_min_t)
                          & ~coll_twin & (d["qs"] >= 0.95))
        return d


class TestEngineGeometryOracle:
    """Engine samplers (stratified=False) vs the reference geometry/mask
    formulas, at the engine's own draws."""

    def test_planet_sampler_masks(self):
        M_s, R_s = 0.9, 0.85
        d = jax.tree_util.tree_map(
            np.asarray,
            eng.sample_planet_target(jax.random.key(0), 3.0, 3.0, M_s, R_s,
                                     N=8192, flatpriors=False,
                                     stratified=False))
        f = np.float32
        a = ((f(G) * f(M_s) * f(MSUN)) / f(4 * np.pi**2)
             * (d["P"] * f(86400.0)) ** 2) ** (1 / 3)
        sin_argp = np.sin(d["argps"] * f(np.pi) / f(180.0))
        e_corr = (1 + d["eccs"] * sin_argp) / (1 - d["eccs"] ** 2)
        Ptra = (d["rps"] * f(REARTH) + f(R_s) * f(RSUN)) / a * e_corr
        coll = (d["rps"] * f(REARTH) + f(R_s) * f(RSUN)) > a * (1 - d["eccs"])
        cosi = np.cos(d["incs"] * f(np.pi) / f(180.0))
        mask_ref = (Ptra <= 1.0) & (cosi <= Ptra) & ~coll
        # borderline f32 rounding may flip individual draws; anything
        # else is a formula divergence
        diff = mask_ref != d["mask"]
        borderline = (np.abs(cosi - Ptra) < 1e-5) | (np.abs(Ptra - 1) < 1e-5)
        assert np.all(~diff | borderline)
        assert diff.mean() < 0.001
        np.testing.assert_allclose(d["a"], a, rtol=1e-5)
        r = a * (1 - d["eccs"] ** 2) / (1 + d["eccs"] * sin_argp)
        b_ref = r * cosi / (f(R_s) * f(RSUN))
        np.testing.assert_allclose(d["b"], b_ref, rtol=2e-4, atol=1e-4)

    def test_teb_sampler_masks(self):
        M_s, R_s, Teff = 1.1, 1.2, 6100.0
        d = jax.tree_util.tree_map(
            np.asarray,
            eng.sample_teb(jax.random.key(1), 3.0, 3.0, M_s, R_s, Teff,
                           N=8192, stratified=False))
        f = np.float32
        masses = d["qs"] * f(M_s)
        radii, _ = stellar_relations(masses, np.full_like(masses, R_s),
                                     np.full_like(masses, Teff))
        radii = radii.astype(np.float32)
        a = ((f(G) * (f(M_s) + masses) * f(MSUN)) / f(4 * np.pi**2)
             * (d["P"] * f(86400.0)) ** 2) ** (1 / 3)
        a_twin = ((f(G) * (f(M_s) + masses) * f(MSUN)) / f(4 * np.pi**2)
                  * (2 * d["P"] * f(86400.0)) ** 2) ** (1 / 3)
        sin_argp = np.sin(d["argps"] * f(np.pi) / f(180.0))
        e_corr = (1 + d["eccs"] * sin_argp) / (1 - d["eccs"] ** 2)
        Ptra = (radii * f(RSUN) + f(R_s) * f(RSUN)) / a * e_corr
        Ptra_twin = (radii * f(RSUN) + f(R_s) * f(RSUN)) / a_twin * e_corr
        coll = (radii * f(RSUN) + f(R_s) * f(RSUN)) > a * (1 - d["eccs"])
        coll_twin = (2 * f(R_s) * f(RSUN)) > a_twin * (1 - d["eccs"])
        cosi = np.cos(d["incs"] * f(np.pi) / f(180.0))
        cosi_t = np.cos(d["incs_twin"] * f(np.pi) / f(180.0))
        mask_ref = (Ptra <= 1.0) & (cosi <= Ptra) & ~coll & (d["qs"] < 0.95)
        mask_twin_ref = ((Ptra_twin <= 1.0) & (cosi_t <= Ptra_twin)
                         & ~coll_twin & (d["qs"] >= 0.95))
        for mine, ref, P_, c_ in ((d["mask"], mask_ref, Ptra, cosi),
                                  (d["mask_twin"], mask_twin_ref,
                                   Ptra_twin, cosi_t)):
            diff = mine != ref
            borderline = (np.abs(c_ - P_) < 1e-5) | (np.abs(P_ - 1) < 1e-5)
            assert np.all(~diff | borderline)
            assert diff.mean() < 0.001
        np.testing.assert_allclose(d["a"], a, rtol=2e-5)
        np.testing.assert_allclose(d["a_twin"], a_twin, rtol=2e-5)
        np.testing.assert_allclose(d["radii"], radii, rtol=2e-4)
        # the reference's collision radius for the twin branch is 2 R_s,
        # not radii + R_s (ml.py:254-268 via SURVEY quirks)
        assert np.array_equal(
            d["mask_twin"] | ~(d["qs"] >= 0.95) | ~(Ptra_twin <= 1.0)
            | ~(cosi_t <= Ptra_twin) | coll_twin,
            np.ones_like(d["mask_twin"]))


class TestBackgroundOracle:
    """Background-scenario chains (DTP/BTP/BEB) vs the reference
    formulas at the engine's own draws: draw-index quirks, dilution
    direction, density prior, clamps, distance correction
    (reference ml.py:1379-1568 DTP, :1840-2035 BTP, :2038-2362 BEB)."""

    def _bg(self, n=64, seed=5):
        rng = np.random.default_rng(seed)
        fr = rng.uniform(0.005, 0.45, n).astype(np.float32)
        bg = dict(
            fluxratios=fr,
            delta_band=(-2.5 * np.log10(fr / (1 - fr))).astype(np.float32),
            masses=rng.uniform(0.2, 1.4, n).astype(np.float32),
            radii=rng.uniform(0.2, 1.5, n).astype(np.float32),
            loggs=rng.uniform(3.0, 5.0, n).astype(np.float32),
            teffs=rng.uniform(3200, 11000, n).astype(np.float32),
            u1s=rng.uniform(0.2, 0.6, n).astype(np.float32),
            u2s=rng.uniform(0.0, 0.3, n).astype(np.float32),
        )
        bg["fluxratios_cc"] = bg["fluxratios"]
        return {k: jnp.asarray(v) for k, v in bg.items()}, n

    def test_dtp_chain(self):
        bg, n = self._bg()
        seps = jnp.asarray(np.array([2.2], np.float32))
        cons = jnp.asarray(np.array([1.0], np.float32))
        d = jax.tree_util.tree_map(np.asarray, eng.sample_background_planet(
            jax.random.key(3), 3.0, 3.0, np.float32(1.0), np.float32(1.0),
            bg, seps, cons, N=8192, flatpriors=False, has_cc=False,
            host_is_bg=False, stratified=False))
        # DTP randint high = N_comp - 1 (exclusive): the last star is
        # never drawn (ml.py:1463)
        assert d["idxs"].max() <= n - 2
        fr = np.asarray(bg["fluxratios"])[d["idxs"]]
        F = fr / (1 - fr)
        np.testing.assert_allclose(d["g"], 1.0 / (1.0 + F), rtol=1e-6)
        # density prior: ln(N/0.1 deg^2 * 2.2^2/3600^2), clamped <= 0;
        # companions brighter than the host (delta_mag > 0) -> -inf
        lnp_const = np.log((n / 0.1) * (1.0 / 3600.0) ** 2 * 2.2**2)
        delta_mags = 2.5 * np.log10(F)
        lnp_ref = np.minimum(np.full_like(F, lnp_const), 0.0)
        lnp_ref = np.where(delta_mags > 0.0, -np.inf, lnp_ref)
        np.testing.assert_allclose(d["lnprior"], lnp_ref, rtol=1e-6)
        # host is the target: no population cut enters the mask
        assert d["host_mass"].min() == d["host_mass"].max() == 1.0

    def test_btp_chain(self):
        bg, n = self._bg()
        seps = jnp.asarray(np.array([2.2], np.float32))
        cons = jnp.asarray(np.array([1.0], np.float32))
        d = jax.tree_util.tree_map(np.asarray, eng.sample_background_planet(
            jax.random.key(4), 3.0, 3.0, np.float32(1.0), np.float32(1.0),
            bg, seps, cons, N=8192, flatpriors=False, has_cc=False,
            host_is_bg=True, stratified=False))
        # BTP randint high = N_comp: all stars reachable (ml.py:1926)
        assert d["idxs"].max() == n - 1
        fr = np.asarray(bg["fluxratios"])[d["idxs"]]
        F = fr / (1 - fr)
        # host is the background star: opposite dilution direction
        np.testing.assert_allclose(d["g"], 1.0 / (1.0 + 1.0 / F),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            d["host_mass"], np.asarray(bg["masses"])[d["idxs"]], rtol=1e-6)
        # population cuts (logg >= 3.5, Teff <= 10000) enter the mask
        bad = ((np.asarray(bg["loggs"])[d["idxs"]] < 3.5)
               | (np.asarray(bg["teffs"])[d["idxs"]] > 10000.0))
        assert not np.any(d["mask"] & bad)

    def test_beb_distance_correction(self):
        bg, n = self._bg()
        seps = jnp.asarray(np.array([2.2], np.float32))
        cons = jnp.asarray(np.array([1.0], np.float32))
        M_s = np.float32(1.0)
        d = jax.tree_util.tree_map(np.asarray, eng.sample_background_eb(
            jax.random.key(5), 3.0, 3.0, M_s, np.float32(1.0),
            np.float32(5800.0), bg, seps, cons, N=8192, has_cc=False,
            host_is_bg=True, stratified=False))
        idxs = d["idxs"]
        host_mass = np.asarray(bg["masses"])[idxs]
        fr_draw = np.asarray(bg["fluxratios"])[idxs]
        f_host = flux_relation(host_mass, "TESS")
        f_targ = flux_relation(np.array([1.0]), "TESS")
        fr_bound = f_host / (f_host + f_targ)
        dist_corr = fr_draw / fr_bound
        f_eb = flux_relation(d["qs"] * host_mass, "TESS")
        fr_eb_ref = (f_eb / (f_eb + f_targ)) * dist_corr
        np.testing.assert_allclose(d["fluxratios"], fr_eb_ref, rtol=2e-4)
