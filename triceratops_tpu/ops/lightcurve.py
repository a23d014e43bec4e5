"""Chunked transit/eclipse likelihood cores (the hot path).

Each core evaluates, for N Monte-Carlo draws at once, the model light
curve on the supersampled time grid, applies flux-dilution algebra, and
accumulates chi^2 against the observed light curve — all inside one jitted
program, blocked over the draw axis so memory stays O(chunk x n_ss)
(SURVEY.md section 5.7: block the draw axis, accumulate chi^2 on the fly).

Two execution paths per core (static flag ``exact``):

* fast (default): the per-draw Chebyshev deficit proxy + per-exposure
  Kepler solves from ops/fastcore.py — ~10-20x fewer transcendentals
  per (draw, sample) at < 1e-6 absolute flux error (validated in
  tests/test_fastcore.py).
* exact: direct kernel + Kepler evaluation at every supersample, used as
  the validation anchor.

Numerical design: the model is carried as a *deficit* from unity, so the
residual (flux_obs - model) = obs_dev + g * deficit is formed without
catastrophic cancellation in float32 (obs_dev = flux_obs - 1 is
precomputed on host in f64). Dilution chains collapse to a single
multiplier g:

    TP   (ref likelihoods.py:58-79):  flux = (f + Fd)/(1 + Fd)
         => deficit_total = D / (1 + Fd),           g = 1/(1+Fd)
    EB   (ref likelihoods.py:115-160): two chained dilutions
         => g_pri = 1/((1+x1)(1+x2)); secondary depth uses
            g_sec = 1/((1+y1)(1+y2)) on the fixed 25-point grid
            linspace(-0.05, 0.05, 25) with w+180 deg and k -> 1/k.

The secondary-eclipse veto (reject draw when diluted secondary depth >=
1.5 sigma, ref likelihoods.py:535-538) is applied as a mask (excluded
draws keep zero weight but count in the N_total denominator).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..core.kepler import projected_z
from .occult import occult_quad_deficit
from .fastcore import (
    deficit_coeffs, cheb_deficit_eval, exposure_z2_poly, z_supersampled,
)

# Fixed secondary-eclipse scan grid (reference likelihoods.py:135, :421)
SEC_GRID = np.linspace(-0.05, 0.05, 25)

LN2PI = float(np.log(2.0 * np.pi))


def supersample_times(time: np.ndarray, exptime: float, nsamples: int) -> np.ndarray:
    """Supersampled exposure grid, (n_t * nsamples,) host array.

    Each exposure of length ``exptime`` is sampled at ``nsamples``
    midpoints (PyTransit-style exposure-time integration,
    ref likelihoods.py:61)."""
    time = np.asarray(time, dtype=np.float64)
    if nsamples <= 1:
        return time
    offs = exptime * ((np.arange(nsamples) + 0.5) / nsamples - 0.5)
    return (time[:, None] + offs[None, :]).reshape(-1)


def _ss_offsets(exptime: float, ns: int):
    return exptime * ((np.arange(ns) + 0.5) / ns - 0.5)


def _pad_chunk(arrs, N, chunk):
    n_chunks = -(-N // chunk)
    pad = n_chunks * chunk - N
    out = []
    for a in arrs:
        a = jnp.asarray(a)
        if pad:
            a = jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
        out.append(a.reshape((n_chunks, chunk) + a.shape[1:]))
    return out


def _mean_deficit_exact(time, exptime, k, P, a_R, inc, e, w, u1, u2,
                        n_t, ns):
    """Exact path: full Kepler + kernel per supersample, (chunk, n_t)."""
    if ns > 1:
        # supersample-major ordering (ns, n_t) flattened: the time axis
        # stays minor (contiguous) when reshaped back for the mean
        offs = jnp.asarray(_ss_offsets(exptime, ns), time.dtype)
        t_ss = (offs[:, None] + time[None, :]).reshape(-1)
    else:
        t_ss = time
    z, front = projected_z(
        t_ss[None, :], 0.0, P[:, None], a_R[:, None],
        inc[:, None], e[:, None], w[:, None],
    )
    D = occult_quad_deficit(k[:, None], z, u1[:, None], u2[:, None])
    D = jnp.where(front, D, 0.0)
    if ns > 1:
        D = D.reshape(D.shape[0], ns, n_t).mean(axis=1)
    return D


_GL_EXPO_MAX = 4


def draw_chunk(n_t: int, ns: int) -> int:
    """Draw-axis chunk size for the lnL cores: keeps the (chunk,
    n_t * gl_nodes) f32 intermediate ~40 MB, at most 16k draws; shared by
    the serial frontend and the sharded/catalog paths so the heuristic
    lives in one place."""
    n_ss = n_t * min(max(ns, 1), _GL_EXPO_MAX)
    return int(max(256, min(16384, (1 << 25) // max(n_ss, 1))))


def _gl_exposure_nodes(exptime: float, ns: int):
    """Gauss-Legendre nodes/weights over one exposure.

    The reference integrates the exposure with an ns-point midpoint rule
    (PyTransit supersampling); a low-order GL rule matches the same
    integral to well below the kernel tolerance at a fraction of the
    evaluations. GL-4 passes every fast-vs-exact gate
    (tests/test_fastcore.py) and leaves lnZ within 3e-4 of the exact
    path at both 2-min and 30-min cadence; at 30-min cadence the
    dominant (still evidence-neutral) fast-path error is the quadratic
    z^2(t) exposure model, not the node count."""
    n_eff = min(ns, _GL_EXPO_MAX)
    x, wgt = np.polynomial.legendre.leggauss(n_eff)
    return (exptime / 2.0 * x).astype(np.float32), (wgt / 2.0).astype(np.float32)


def _mean_deficit_fast(time, exptime, k, P, a_R, inc, e, w, u1, u2,
                       n_t, ns):
    """Fast path: Chebyshev deficit proxy + per-exposure Kepler."""
    coeffs = deficit_coeffs(k, u1, u2)
    if ns > 1:
        h = exptime / 2.0
        q0, q1, q2, front = exposure_z2_poly(time, h, P, a_R, inc, e, w)
        offs, wgt = _gl_exposure_nodes(exptime, ns)
        z = z_supersampled(q0, q1, q2, jnp.asarray(offs))  # (chunk, n_eff, n_t)
        D = cheb_deficit_eval(coeffs, z.reshape(z.shape[0], -1))
        D = D.reshape(z.shape) * front[:, None, :]
        return jnp.sum(D * jnp.asarray(wgt)[None, :, None], axis=1)
    z, front = projected_z(time[None, :], 0.0, P[:, None], a_R[:, None],
                           inc[:, None], e[:, None], w[:, None])
    D = cheb_deficit_eval(coeffs, z)
    return jnp.where(front, D, 0.0)


def _mean_deficit(time, exptime, k, P, a_R, inc, e, w, u1, u2, n_t, ns,
                  exact):
    fn = _mean_deficit_exact if exact else _mean_deficit_fast
    return fn(time, exptime, k, P, a_R, inc, e, w, u1, u2, n_t, ns)


@partial(jax.jit,
         static_argnames=("exptime", "n_t", "ns", "chunk", "exact"))
def lnL_planet(time, obs_dev, sigma, k, P, a_R, inc, e, w, u1, u2, g, mask,
               *, exptime: float, n_t: int, ns: int, chunk: int = 4096,
               exact: bool = False):
    """Transiting-planet family log-likelihoods for N draws.

    Returns lnL (N,) = -0.5 ln 2pi - ln sigma - 0.5 chi^2 for masked-in
    draws, -inf otherwise (reference marginal_likelihoods.py:117-137)."""
    N = k.shape[0]
    inv_sig2 = 1.0 / (sigma * sigma)
    ln_sigma = jnp.log(sigma)
    (k_, P_, aR_, inc_, e_, w_, u1_, u2_, g_, m_) = _pad_chunk(
        [k, P, a_R, inc, e, w, u1, u2, g, mask], N, chunk)

    def body(args):
        kc, Pc, ac, ic, ec, wc, u1c, u2c, gc, mc = args
        D = _mean_deficit(time, exptime, kc, Pc, ac, ic, ec, wc, u1c, u2c,
                          n_t, ns, exact)
        resid = obs_dev[None, :] + gc[:, None] * D
        chi2 = jnp.sum(resid * resid, axis=1) * inv_sig2
        lnL = -0.5 * LN2PI - ln_sigma - 0.5 * chi2
        return jnp.where(mc, lnL, -jnp.inf)

    lnL = jax.lax.map(body, (k_, P_, aR_, inc_, e_, w_, u1_, u2_, g_, m_))
    return lnL.reshape(-1)[:N]


@partial(jax.jit,
         static_argnames=("exptime", "n_t", "ns", "chunk", "apply_veto",
                          "exact"))
def lnL_eb(time, obs_dev, sigma, k, ksec, P, a_R, inc, e, w, u1, u2,
           g_pri, g_sec, mask, *, exptime: float, n_t: int, ns: int,
           chunk: int = 4096, apply_veto: bool = True, exact: bool = False):
    """Eclipsing-binary family log-likelihoods for N draws.

    k is the (already quirk-adjusted) primary radius ratio, ksec the
    secondary ratio. When apply_veto, draws whose diluted secondary depth
    >= 1.5 sigma are excluded (ref likelihoods.py:535-538); the twin
    branch passes apply_veto=False (ref likelihoods.py:542-587). The
    25-point secondary scan always uses the exact kernel (it is a
    negligible fraction of the work)."""
    N = k.shape[0]
    inv_sig2 = 1.0 / (sigma * sigma)
    ln_sigma = jnp.log(sigma)
    sec_grid = jnp.asarray(SEC_GRID, dtype=time.dtype)
    (k_, ks_, P_, aR_, inc_, e_, w_, u1_, u2_, gp_, gs_, m_) = _pad_chunk(
        [k, ksec, P, a_R, inc, e, w, u1, u2, g_pri, g_sec, mask], N, chunk)

    def body(args):
        kc, ksc, Pc, ac, ic, ec, wc, u1c, u2c, gpc, gsc, mc = args
        D = _mean_deficit(time, exptime, kc, Pc, ac, ic, ec, wc, u1c, u2c,
                          n_t, ns, exact)
        resid = obs_dev[None, :] + gpc[:, None] * D
        chi2 = jnp.sum(resid * resid, axis=1) * inv_sig2
        lnL = -0.5 * LN2PI - ln_sigma - 0.5 * chi2
        if apply_veto:
            # secondary eclipse scan: w + 180 deg, k -> ksec, no
            # supersampling, scan axis leading (25, chunk). The deficit is
            # monotone non-increasing in z, so the scan's max deficit
            # equals ONE kernel eval at the minimum in-front z — 25x fewer
            # exact-kernel calls than evaluating the grid.
            zs, fronts = projected_z(
                sec_grid[:, None], 0.0, Pc[None, :], ac[None, :],
                ic[None, :], ec[None, :], wc[None, :] + jnp.pi,
            )
            big = jnp.asarray(1e30, zs.dtype)
            z_eff = jnp.min(jnp.where(fronts, zs, big), axis=0)
            has_front = jnp.any(fronts, axis=0)
            D_eff = occult_quad_deficit(ksc, jnp.minimum(z_eff, big), u1c, u2c)
            secdepth = gsc * jnp.where(has_front, D_eff, 0.0)
            mc = mc & (secdepth < 1.5 * sigma)
        return jnp.where(mc, lnL, -jnp.inf)

    lnL = jax.lax.map(body, (k_, ks_, P_, aR_, inc_, e_, w_, u1_, u2_,
                             gp_, gs_, m_))
    return lnL.reshape(-1)[:N]


def eb_radius_ratios(radii, R_host):
    """Primary/secondary radius ratios with the reference's batch-path
    near-unity adjustment: all k < 1 + 1e-6 scaled by 0.999
    (reference likelihoods.py:405-406, :417-418; the serial path only
    adjusts |k-1| < 1e-6 — we standardize on the batch behavior, which is
    what produced the published numbers)."""
    k = radii / R_host
    k = jnp.where((k - 1.0) < 1e-6, k * 0.999, k)
    ksec = R_host / radii
    ksec = jnp.where((ksec - 1.0) < 1e-6, ksec * 0.999, ksec)
    return k, ksec


def tp_dilution(F_comp, companion_is_host: bool):
    """Deficit multiplier g for the TP dilution chain
    (reference likelihoods.py:352-357)."""
    if companion_is_host:
        return 1.0 / (1.0 + 1.0 / F_comp)
    return 1.0 / (1.0 + F_comp)


def eb_dilution(F_EB, F_comp, companion_is_host: bool):
    """(g_pri, g_sec) deficit multipliers for the EB dilution chains
    (reference likelihoods.py:427-438)."""
    if companion_is_host:
        x1 = F_EB / F_comp
        x2 = 1.0 / (F_comp + F_EB)
        y1 = F_comp / F_EB
    else:
        x1 = F_EB
        x2 = F_comp / (1.0 + F_EB)
        y1 = 1.0 / F_EB
    g_pri = 1.0 / ((1.0 + x1) * (1.0 + x2))
    g_sec = 1.0 / ((1.0 + y1) * (1.0 + x2))
    return g_pri, g_sec
