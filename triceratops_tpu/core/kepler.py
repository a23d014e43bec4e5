"""Kepler-equation solver and sky-projected separation (JAX, branch-free).

Replaces the orbit machinery inside PyTransit's QuadraticModel
(reference: triceratops/likelihoods.py:61-71 passes t0=0, p, a/R_s, i, e,
w=(90-argp)*pi/180 and PyTransit solves the eccentric orbit internally).

Conventions (matching the standard transit convention PyTransit uses):
  * t0 is the transit (inferior conjunction) epoch: true anomaly
    nu_tc = pi/2 - w at t = t0.
  * w is the argument of periastron in radians (already converted by the
    caller via w = (90 - argp) * pi/180).
  * The planet is "in front" (transits rather than is occulted) when
    sin(w + nu) > 0.

Solver scheme (branch-free, vmappable), per dtype:

* float32 (device hot path): Markley (1995, CeMDA 63, 101) Pade-type
  cubic starter on the wrapped |M| in [0, pi] followed by ONE staged
  Householder-4 correction. The starter needs only cbrt/sqrt (no
  transcendentals) and is accurate to ~2e-2 worst-case over all
  e <= E_MAX, so a single quartic correction lands at the f32
  round-off floor: measured on a 500k-point stress grid (incl.
  e in [0.9, 0.995] near pericenter) max |d sinE| 8.8e-7 vs the
  Newton-4 predecessor's 8.3e-7 — identical to round-off — while
  spending 1 sin/cos pair per point instead of 4.
* float64 (reference-accuracy path): fixed NEWTON_ITERS = 8 Newton
  with the starter E0 = M + e sin M + e^2 sin M cos M augmented by the
  cube-root pericenter behavior E ~ (6M/e)^(1/3); residual < 1e-10.

Both validated in tests/test_kepler.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEWTON_ITERS = 8       # float64 / reference-accuracy path
E_MAX = 0.995  # eccentricity clamp; draws beyond this are unphysical here


def solve_kepler_sc(M, e):
    """Solve E - e sin E = M for E; also return (sin E, cos E).

    Branch-free and vmappable. M is range-reduced to [-pi, pi) first
    (E - M is 2pi-periodic in M), both for convergence and so the
    pericenter starters trigger on the wrapped anomaly for multi-period
    time arrays. The scheme is per-dtype (module docstring):

    * f64: 8 fixed Newton iterations from the classical
      M + e sinM (1 + e cosM) starter (cbrt pericenter override), then a
      second-order Taylor rotation of the final (sinE, cosE) pair by the
      last step dE (|dE| far below 1e-5, expansion error O(dE^3) —
      negligible vs f64 round-off).
    * f32 (device hot path): Markley (1995) cubic starter + ONE staged
      Householder-4 correction, then a third-order Taylor rotation by
      the final step (|dE| <= starter error ~2e-2, expansion error
      O(dE^4) ~ 7e-9). One sin/cos pair per point total; measured
      max |d sinE| ~ 8.8e-7 on the 500k stress grid
      (tests/test_kepler.py gates the returned pair at 1.5e-6).

    Either way the hot callers save one full sin+cos pair per
    (draw, time) point by consuming the returned pair.

    Consistency caveat (f32): sinE/cosE are consistent with the
    *wrapped* anomaly. The returned E is unwrapped (+2pi*k to match M's
    branch), so at large |M| it carries ~eps*|M| f32 representation
    error and recomputing jnp.sin(E) from it can disagree with the
    returned sinE by up to ~3e-6 — the returned pair is the *more*
    accurate one (~7.5e-7 vs f64 truth). Callers must use the returned
    (sinE, cosE), never re-derive them from E."""
    e = jnp.clip(e, 0.0, E_MAX)
    two_pi = 2.0 * jnp.pi
    k = jnp.round(M / two_pi)
    # compensated wrap: 2pi split into a few-mantissa-bit head (so
    # k * head is exact in f32) and a tail; a naive M - 2pi*k loses
    # ~eps(|M|) absolute, which near pericenter at high e amplifies
    # ~100x through dE/dM
    Mw = (M - k * 6.28125) - k * 0.001935307179586232
    if jnp.result_type(M, e) == jnp.float64:
        sinM = jnp.sin(Mw)
        cosM = jnp.cos(Mw)
        E = Mw + e * sinM + e * e * sinM * cosM
        Ecb = jnp.cbrt(6.0 * Mw / jnp.maximum(e, 1e-6))
        E = jnp.where((jnp.abs(Mw) < 0.25) & (e > 0.9), Ecb, E)
        sinE = cosE = dE = None
        for _ in range(NEWTON_ITERS):
            sinE = jnp.sin(E)
            cosE = jnp.cos(E)
            f = E - e * sinE - Mw
            fp = 1.0 - e * cosE
            dE = -f / fp
            E = E + dE
        sinEf = sinE + dE * (cosE - 0.5 * dE * sinE)
        cosEf = cosE - dE * (sinE + 0.5 * dE * cosE)
        return E + two_pi * k, sinEf, cosEf
    # float32 device path: Markley (1995) cubic starter on |Mw| (E is odd
    # in M) + one staged Householder-4 correction. Starter worst-case
    # error ~2e-2, so the quartic step reaches the f32 round-off floor
    # with a single sin/cos pair (module docstring; tests/test_kepler.py)
    s = jnp.sign(Mw)
    Ma = jnp.abs(Mw)
    pi = jnp.pi
    alpha = (3.0 * pi * pi + 1.6 * pi * (pi - Ma) / (1.0 + e)) \
        / (pi * pi - 6.0)
    d = 3.0 * (1.0 - e) + alpha * e
    q = 2.0 * alpha * d * (1.0 - e) - Ma * Ma
    r = 3.0 * alpha * d * (d - 1.0 + e) * Ma + Ma * Ma * Ma
    w_ = jnp.cbrt(jnp.abs(r) + jnp.sqrt(jnp.maximum(
        q * q * q + r * r, 0.0))) ** 2
    E = (2.0 * r * w_ / (w_ * w_ + w_ * q + q * q) + Ma) / d
    sinE = jnp.sin(E)
    cosE = jnp.cos(E)
    f = E - e * sinE - Ma
    fp = 1.0 - e * cosE
    fpp = e * sinE
    fppp = e * cosE
    d1 = -f / fp
    d2 = -f / (fp + 0.5 * d1 * fpp)
    dE = -f / (fp + 0.5 * d2 * fpp + d2 * d2 * fppp * (1.0 / 6.0))
    E = E + dE
    # 3rd-order Taylor rotation of (sinE, cosE) by the final step dE
    # (|dE| <= starter error ~2e-2 -> expansion error O(dE^4) ~ 7e-9)
    sinEf = sinE + dE * (cosE - 0.5 * dE * (sinE + dE * cosE * (1.0 / 3.0)))
    cosEf = cosE - dE * (sinE + 0.5 * dE * (cosE - dE * sinE * (1.0 / 3.0)))
    return s * E + two_pi * k, s * sinEf, cosEf


def solve_kepler(M, e):
    """Solve E - e sin E = M for E (see solve_kepler_sc)."""
    return solve_kepler_sc(M, e)[0]


def true_anomaly_from_E(E, e):
    e = jnp.clip(e, 0.0, E_MAX)
    sq = jnp.sqrt((1.0 + e) / (1.0 - e))
    return 2.0 * jnp.arctan2(sq * jnp.sin(E / 2.0), jnp.cos(E / 2.0))


def mean_anomaly_at_transit(e, w):
    """Mean anomaly at inferior conjunction (nu = pi/2 - w)."""
    e = jnp.clip(e, 0.0, E_MAX)
    nu_tc = jnp.pi / 2.0 - w
    E_tc = 2.0 * jnp.arctan2(
        jnp.sqrt(1.0 - e) * jnp.sin(nu_tc / 2.0),
        jnp.sqrt(1.0 + e) * jnp.cos(nu_tc / 2.0),
    )
    return E_tc - e * jnp.sin(E_tc)


def z2_taylor(t, t0, P, a_R, inc, e, w):
    """z^2 and its first two time derivatives, from ONE Kepler solve.

    Closed-form orbital kinematics (Edot = n/beta, nudot =
    n sqrt(1-e^2)/beta^2, rdot = a e n sinE / beta, and their time
    derivatives) replace the two extra Kepler solves a finite-difference
    quadratic needs. Used by the fast exposure-integration path
    (ops/fastcore.exposure_z2_poly). Same conventions as projected_z.

    Returns (z2, dz2/dt, d2z2/dt2, front).
    """
    e = jnp.clip(e, 0.0, E_MAX)
    n = 2.0 * jnp.pi / P
    M_tc = mean_anomaly_at_transit(e, w)
    M = M_tc + n * (t - t0)
    E, sinE, cosE = solve_kepler_sc(M, e)
    beta = 1.0 - e * cosE
    ome2 = jnp.sqrt((1.0 - e) * (1.0 + e))
    r = a_R * beta
    rdot = a_R * e * n * sinE / beta
    rdd = a_R * e * n * n * (cosE * beta - e * sinE * sinE) / (beta * beta * beta)
    nudot = n * ome2 / (beta * beta)
    nudd = -2.0 * e * n * n * ome2 * sinE / (beta * beta * beta * beta)
    # sin/cos(w + nu) algebraically from E: cos nu = (cos E - e)/beta,
    # sin nu = sqrt(1-e^2) sin E / beta, and sin/cos(w) are per-draw
    # (broadcast over the time axis) — this removes one arctan2 and two
    # per-point transcendentals from the hot path (~tens of ms per
    # 1e6-draw core)
    inv_beta = 1.0 / beta
    cnu = (cosE - e) * inv_beta
    snu = ome2 * sinE * inv_beta
    sw = jnp.sin(w)
    cw = jnp.cos(w)
    su = sw * cnu + cw * snu
    cu = cw * cnu - sw * snu
    S = jnp.sin(inc) ** 2
    C = jnp.cos(inc) ** 2
    s2u = 2.0 * su * cu
    c2u = 1.0 - 2.0 * su * su
    # 1 - S su^2 rewritten as cu^2 + C su^2 (exact identity): near
    # mid-transit su -> 1 and the subtraction cancels catastrophically
    # in f32 (the algebraic su carries ~1e-7 absolute error with no
    # flat-sine suppression), while the sum-of-squares form keeps z^2
    # to ~1e-7 absolute — measured 4.7e-4 -> 1e-6 max in-transit z
    # error on the fast-vs-exact gate draws
    A = cu * cu + C * (su * su)
    z2 = r * r * A
    dz2 = 2.0 * r * rdot * A - r * r * S * s2u * nudot
    d2z2 = (2.0 * (rdot * rdot + r * rdd) * A
            - 4.0 * r * rdot * S * s2u * nudot
            - r * r * S * (2.0 * c2u * nudot * nudot + s2u * nudd))
    return z2, dz2, d2z2, su > 0.0


def projected_z(t, t0, P, a_R, inc, e, w):
    """Sky-projected star-planet separation in stellar radii, plus
    visibility sign.

    Args:
        t: times [days]; broadcastable against the orbital parameters.
        t0: transit epoch [days].
        P: orbital period [days].
        a_R: semimajor axis in stellar radii.
        inc: inclination [radians].
        e: eccentricity.
        w: argument of periastron [radians].
    Returns:
        (z, front): separation in stellar radii, and boolean mask that is
        True when the planet is on the near side (transit visible).
    """
    e = jnp.clip(e, 0.0, E_MAX)
    M_tc = mean_anomaly_at_transit(e, w)
    M = M_tc + 2.0 * jnp.pi * (t - t0) / P
    E, sinE, cosE = solve_kepler_sc(M, e)
    beta = 1.0 - e * cosE
    # sin(w + nu) algebraically from E (see z2_taylor): avoids the
    # arctan2-based true anomaly and a per-point sin
    inv_beta = 1.0 / beta
    cnu = (cosE - e) * inv_beta
    snu = jnp.sqrt((1.0 - e) * (1.0 + e)) * sinE * inv_beta
    sw = jnp.sin(w)
    cw = jnp.cos(w)
    swnu = sw * cnu + cw * snu
    cwnu = cw * cnu - sw * snu
    # quadrature form of sqrt(1 - sin^2 i sin^2(w+nu)) — see z2_taylor:
    # the sum of squares avoids the near-transit f32 cancellation
    z = a_R * beta * jnp.sqrt(
        cwnu * cwnu + jnp.cos(inc) ** 2 * (swnu * swnu)
    )
    return z, swnu > 0.0
