"""Photometric forward models and chi^2 likelihoods (public API parity).

Mirrors the reference's ``triceratops.likelihoods`` surface
(reference: triceratops/likelihoods.py:27-587): scalar and batch ("_p")
transiting-planet and eclipsing-binary light-curve simulators plus their
log-likelihoods, built on the branch-free occultation kernel instead of
PyTransit. Conventions preserved:

* w = (90 - argp) deg, t0 = 0 at mid-transit;
* EB secondary-eclipse depth from the fixed 25-point grid
  linspace(-0.05, 0.05, 25) with w + 180 deg and k -> 1/k;
* near-unity radius-ratio adjustment (batch rule: k < 1 + 1e-6 scaled by
  0.999 — likelihoods.py:405-406);
* lnL_* return +0.5 * chi^2 (positive; negated by callers);
* EB secondary veto: lnL = +inf when diluted secondary depth >= 1.5 sigma.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .constants import RSUN, REARTH, PI
from .core.kepler import projected_z
from .ops.occult import occult_quad_deficit
from .ops.lightcurve import SEC_GRID, supersample_times


@partial(jax.jit, static_argnames=("n_t", "ns"))
def _deficit_curve(t_ss, k, P_orb, a_R, inc_rad, e, w_rad, u1, u2,
                   *, n_t, ns):
    """Mean-over-supersamples deficit for a batch of parameter rows."""
    z, front = projected_z(t_ss[None, :], 0.0, P_orb[:, None], a_R[:, None],
                           inc_rad[:, None], e[:, None], w_rad[:, None])
    D = occult_quad_deficit(k[:, None], z, u1[:, None], u2[:, None])
    D = jnp.where(front, D, 0.0)
    if ns > 1:
        D = D.reshape(D.shape[0], n_t, ns).mean(axis=2)
    return D


def _atleast1(*xs):
    return [np.atleast_1d(np.asarray(x, dtype=np.float64)) for x in xs]


def _host_deficit(time, k, P_orb, a_R, inc_deg, ecc, argp_deg, u1, u2,
                  exptime, nsamples):
    k, P_orb, a_R, inc_deg, ecc, argp_deg, u1, u2 = _atleast1(
        k, P_orb, a_R, inc_deg, ecc, argp_deg, u1, u2)
    n = max(map(len, (k, P_orb, a_R, inc_deg, ecc, argp_deg, u1, u2)))
    k, P_orb, a_R, inc_deg, ecc, argp_deg, u1, u2 = [
        np.broadcast_to(a, (n,)) for a in
        (k, P_orb, a_R, inc_deg, ecc, argp_deg, u1, u2)]
    t_ss = supersample_times(np.asarray(time, float), exptime, nsamples)
    D = _deficit_curve(
        jnp.asarray(t_ss), jnp.asarray(k), jnp.asarray(P_orb),
        jnp.asarray(a_R), jnp.asarray(np.deg2rad(inc_deg)),
        jnp.asarray(ecc), jnp.asarray(np.deg2rad(90.0 - argp_deg)),
        jnp.asarray(u1), jnp.asarray(u2), n_t=len(time), ns=nsamples)
    return np.asarray(D)


def simulate_TP_transit(time, R_p, P_orb, inc, a, R_s, u1, u2, ecc, argp,
                        companion_fluxratio: float = 0.0,
                        companion_is_host: bool = False,
                        exptime: float = 0.00139, nsamples: int = 20):
    """Transiting-planet light curve (reference likelihoods.py:27-80).
    ``a`` in cm, ``R_s`` in Rsun, angles in degrees."""
    F_comp = companion_fluxratio / (1 - companion_fluxratio)
    D = _host_deficit(time, R_p * REARTH / (R_s * RSUN), P_orb,
                      a / (R_s * RSUN), inc, ecc, argp, u1, u2,
                      exptime, nsamples)[0]
    F_dilute = (1.0 / F_comp) if companion_is_host else F_comp
    return 1.0 - D / (1.0 + F_dilute)


def _eb_k(k):
    k = np.atleast_1d(np.asarray(k, float)).copy()
    k[(k - 1.0) < 1e-6] *= 0.999
    return k


def simulate_EB_transit(time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1,
                        u2, ecc, argp, companion_fluxratio: float = 0.0,
                        companion_is_host: bool = False,
                        exptime: float = 0.00139, nsamples: int = 20):
    """Eclipsing-binary light curve + secondary depth
    (reference likelihoods.py:83-160)."""
    F_comp = companion_fluxratio / (1 - companion_fluxratio)
    F_EB = EB_fluxratio / (1 - EB_fluxratio)
    k = _eb_k(np.asarray(R_EB, float) / np.asarray(R_s, float))[0]
    a_R = a / (R_s * RSUN)
    D = _host_deficit(time, k, P_orb, a_R, inc, ecc, argp, u1, u2,
                      exptime, nsamples)[0]
    D_sec = _host_deficit(SEC_GRID, 1.0 / k, P_orb, a_R, inc, ecc,
                          argp - 180.0, u1, u2, 0.0, 1)[0]
    sec_deficit = np.max(D_sec)
    if companion_is_host:
        x1, y1 = F_EB / F_comp, F_comp / F_EB
        x2 = 1.0 / (F_comp + F_EB)
    else:
        x1, y1 = F_EB, 1.0 / F_EB
        x2 = F_comp / (1.0 + F_EB)
    flux = 1.0 - D / ((1.0 + x1) * (1.0 + x2))
    secdepth = sec_deficit / ((1.0 + y1) * (1.0 + x2))
    return flux, secdepth


def lnL_TP(time, flux, sigma, R_p, P_orb, inc, a, R_s, u1, u2, ecc, argp,
           companion_fluxratio: float = 0.0, companion_is_host: bool = False,
           exptime: float = 0.00139, nsamples: int = 20):
    """+0.5 chi^2 of the TP model (reference likelihoods.py:164-204)."""
    model = simulate_TP_transit(time, R_p, P_orb, inc, a, R_s, u1, u2, ecc,
                                argp, companion_fluxratio, companion_is_host,
                                exptime, nsamples)
    return 0.5 * np.sum((flux - model) ** 2 / sigma**2)


def lnL_EB(time, flux, sigma, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1,
           u2, ecc, argp, companion_fluxratio: float = 0.0,
           companion_is_host: bool = False, exptime: float = 0.00139,
           nsamples: int = 20):
    """+0.5 chi^2 with the secondary veto (reference likelihoods.py:207-253)."""
    model, secdepth = simulate_EB_transit(
        time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1, u2, ecc, argp,
        companion_fluxratio, companion_is_host, exptime, nsamples)
    if secdepth < 1.5 * sigma:
        return 0.5 * np.sum((flux - model) ** 2 / sigma**2)
    return np.inf


def lnL_EB_twin(time, flux, sigma, R_EB, EB_fluxratio, P_orb, inc, a, R_s,
                u1, u2, ecc, argp, companion_fluxratio: float = 0.0,
                companion_is_host: bool = False, exptime: float = 0.00139,
                nsamples: int = 20):
    """Twin variant: no secondary veto (reference likelihoods.py:256-299)."""
    model, _secdepth = simulate_EB_transit(
        time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1, u2, ecc, argp,
        companion_fluxratio, companion_is_host, exptime, nsamples)
    return 0.5 * np.sum((flux - model) ** 2 / sigma**2)


# ---------------------------------------------------------------------------
# Batch variants (reference likelihoods.py:302-587)
# ---------------------------------------------------------------------------

def simulate_TP_transit_p(time, R_p, P_orb, inc, a, R_s, u1, u2, ecc, argp,
                          companion_fluxratio, companion_is_host=False,
                          exptime: float = 0.00139, nsamples: int = 20):
    """Batched TP light curves (reference likelihoods.py:302-358)."""
    F_comp = np.asarray(companion_fluxratio, float)
    F_comp = (F_comp / (1 - F_comp))[:, None]
    D = _host_deficit(time, np.asarray(R_p) * REARTH / (np.asarray(R_s) * RSUN),
                      P_orb, np.asarray(a) / (np.asarray(R_s) * RSUN),
                      inc, ecc, argp, u1, u2, exptime, nsamples)
    F_dilute = (1.0 / F_comp) if companion_is_host else F_comp
    return 1.0 - D / (1.0 + F_dilute)


def simulate_EB_transit_p(time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1,
                          u2, ecc, argp, companion_fluxratio,
                          companion_is_host=False, exptime: float = 0.00139,
                          nsamples: int = 20):
    """Batched EB light curves + secondary depths
    (reference likelihoods.py:361-439)."""
    F_comp = np.asarray(companion_fluxratio, float)
    F_comp = (F_comp / (1 - F_comp))[:, None]
    F_EB = np.asarray(EB_fluxratio, float)
    F_EB = (F_EB / (1 - F_EB))[:, None]
    k = _eb_k(np.asarray(R_EB, float) / np.asarray(R_s, float))
    ksec = _eb_k(np.asarray(R_s, float) / np.asarray(R_EB, float))
    a_R = np.asarray(a) / (np.asarray(R_s) * RSUN)
    D = _host_deficit(time, k, P_orb, a_R, inc, ecc, argp, u1, u2,
                      exptime, nsamples)
    D_sec = _host_deficit(SEC_GRID, ksec, P_orb, a_R, inc, ecc,
                          np.asarray(argp, float) - 180.0, u1, u2, 0.0, 1)
    sec_deficit = np.max(D_sec, axis=1)[:, None]
    if companion_is_host:
        x1, y1 = F_EB / F_comp, F_comp / F_EB
        x2 = 1.0 / (F_comp + F_EB)
    else:
        x1, y1 = F_EB, 1.0 / F_EB
        x2 = F_comp / (1.0 + F_EB)
    flux = 1.0 - D / ((1.0 + x1) * (1.0 + x2))
    secdepth = sec_deficit / ((1.0 + y1) * (1.0 + x2))
    return flux, secdepth


def lnL_TP_p(time, flux, sigma, R_p, P_orb, inc, a, R_s, u1, u2, ecc, argp,
             companion_fluxratio, companion_is_host=False,
             exptime: float = 0.00139, nsamples: int = 20):
    """Batched +0.5 chi^2 (reference likelihoods.py:443-487)."""
    model = simulate_TP_transit_p(time, R_p, P_orb, inc, a, R_s, u1, u2,
                                  ecc, argp, companion_fluxratio,
                                  companion_is_host, exptime, nsamples)
    return 0.5 * np.sum((np.asarray(flux) - model) ** 2 / sigma**2, axis=1)


def lnL_EB_p(time, flux, sigma, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1,
             u2, ecc, argp, companion_fluxratio, companion_is_host=False,
             exptime: float = 0.00139, nsamples: int = 20):
    """Batched EB +0.5 chi^2 with veto (reference likelihoods.py:490-539)."""
    model, secdepth = simulate_EB_transit_p(
        time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1, u2, ecc, argp,
        companion_fluxratio, companion_is_host, exptime, nsamples)
    lnL = np.zeros(model.shape[0])
    mask = (secdepth < 1.5 * sigma)[:, 0]
    lnL[mask] = 0.5 * np.sum(
        (np.asarray(flux) - model[mask]) ** 2 / sigma**2, axis=1)
    lnL[~mask] = np.inf
    return lnL


def lnL_EB_twin_p(time, flux, sigma, R_EB, EB_fluxratio, P_orb, inc, a, R_s,
                  u1, u2, ecc, argp, companion_fluxratio,
                  companion_is_host=False, exptime: float = 0.00139,
                  nsamples: int = 20):
    """Batched twin +0.5 chi^2, no veto (reference likelihoods.py:542-587)."""
    model, _ = simulate_EB_transit_p(
        time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1, u2, ecc, argp,
        companion_fluxratio, companion_is_host, exptime, nsamples)
    return 0.5 * np.sum((np.asarray(flux) - model) ** 2 / sigma**2, axis=1)
