"""Inverse-CDF prior samplers (pure functions of uniform draws; JAX).

Each sampler is a deterministic transform of uniforms x ~ U[0,1], mirroring
the reference's formulas (reference: triceratops/priors.py:16-383) but
key-driven and vmappable:

* ``sample_rp``: broken power law in Rp with host-mass-dependent slopes
  (breaks 3.0/6.0 Rearth; slopes (0,-4,-0.5) for M>0.45, (0,-7,-0.5)
  below; flat option) — priors.py:16-116.
* ``sample_inc``: cos-uniform inclination — priors.py:119-132.
* ``sample_ecc``: Kipping (2013) Beta(0.867, 3.030) for planets via a
  precomputed inverse-CDF table; Moe & Di Stefano (2017) power law for
  binaries (exponent 0.2 for P<=10 d else 0.6) — priors.py:134-155. The
  reference draws fresh scipy RVs (discarding x), so only distributional
  equivalence is required (SURVEY.md section 7).
* ``sample_w``: uniform argument of periastron in degrees — priors.py:157.
* ``sample_q`` / ``sample_q_companion``: Moe & Di Stefano broken power law
  mass ratios with twin excess (F_twin=0.30 slope -0.5 short-period;
  F_twin=0.05 slope -0.95 long-period companions), four primary-mass
  regimes — priors.py:168-383.

All functions accept numpy or jax arrays and run under jit.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Planet radius
# ---------------------------------------------------------------------------

def _broken3_constants(p1, p2, p3, r_min, r_b1, r_b2, r_max):
    A1 = r_b1**p1 / r_b1**p2
    A2 = r_b2**p2 / r_b2**p3
    I1 = (r_b1 ** (p1 + 1) - r_min ** (p1 + 1)) / (p1 + 1)
    I2 = A1 * (r_b2 ** (p2 + 1) - r_b1 ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * A1 * (r_max ** (p3 + 1) - r_b2 ** (p3 + 1)) / (p3 + 1)
    return A1, A2, I1, I2, I3, 1.0 / (I1 + I2 + I3)


def _broken3_invcdf(x, p1, p2, p3, r_min, r_b1, r_b2, r_max):
    A1, A2, I1, I2, I3, Norm = _broken3_constants(p1, p2, p3, r_min, r_b1, r_b2, r_max)
    seg1 = (x / Norm * (p1 + 1) + r_min ** (p1 + 1)) ** (1.0 / (p1 + 1))
    seg2 = ((x / Norm - I1) * (p2 + 1) / A1 + r_b1 ** (p2 + 1)) ** (1.0 / (p2 + 1))
    seg3 = ((x / Norm - I1 - I2) * (p3 + 1) / (A1 * A2)
            + r_b2 ** (p3 + 1)) ** (1.0 / (p3 + 1))
    out = jnp.where(x <= Norm * I1, seg1,
                    jnp.where(x <= Norm * (I1 + I2), seg2, seg3))
    return out


def sample_rp(x, M_s, flatpriors: bool = False):
    """Planet radii [Rearth] from uniforms; M_s may be scalar or array."""
    x = jnp.asarray(x)
    if flatpriors:
        return x / (1.0 / 19.5) + 0.5
    hot = _broken3_invcdf(x, 0.0, -4.0, -0.5, 0.5, 3.0, 6.0, 20.0)
    cool = _broken3_invcdf(x, 0.0, -7.0, -0.5, 0.5, 3.0, 6.0, 20.0)
    return jnp.where(jnp.asarray(M_s) > 0.45, hot, cool)


# ---------------------------------------------------------------------------
# Inclination / argument of periastron
# ---------------------------------------------------------------------------

def sample_inc(x, lower: float = 0.0, upper: float = 90.0):
    """Inclinations [deg], density ~ sin (cos-uniform)."""
    norm = 1.0 / (np.cos(lower * np.pi / 180) - np.cos(upper * np.pi / 180))
    return jnp.arccos(np.cos(lower * np.pi / 180) - jnp.asarray(x) / norm) * (180.0 / np.pi)


def sample_w(x):
    """Argument of periastron [deg]."""
    return jnp.asarray(x) * 360.0


# ---------------------------------------------------------------------------
# Eccentricity
# ---------------------------------------------------------------------------

_BETA_A, _BETA_B = 0.867, 3.030
# Gather-free Beta PPF: two Chebyshev segments in the cusp-absorbing
# variables v = u^{1/a} (u <= _BETA_USPLIT; PPF = v R(v), R analytic)
# and w = (1-u)^{1/b} (u > _BETA_USPLIT; PPF = 1 - w S(w)). Replaces the
# former 8193-point jnp.interp table and its binary-search gathers with
# one pow + a 16-step Clenshaw on scalar constants. Max |error| vs
# scipy.stats.beta.ppf: 2.7e-7 over u in [0, 1].
_BETA_USPLIT = 0.9
_BETA_M = 16


@lru_cache(maxsize=None)
def _beta_ppf_cheb():
    from scipy.stats import beta as _beta

    theta = (np.arange(_BETA_M) + 0.5) * np.pi / _BETA_M
    xn = np.cos(theta)
    dct = (2.0 / _BETA_M) * np.cos(np.outer(np.arange(_BETA_M), theta))
    dct[0] *= 0.5
    vmax = _BETA_USPLIT ** (1.0 / _BETA_A)
    v = 0.5 * vmax * (xn + 1.0)
    cL = dct @ (_beta.ppf(v**_BETA_A, _BETA_A, _BETA_B) / v)
    wmax = (1.0 - _BETA_USPLIT) ** (1.0 / _BETA_B)
    w = 0.5 * wmax * (xn + 1.0)
    cH = dct @ ((1.0 - _beta.ppf(1.0 - w**_BETA_B, _BETA_A, _BETA_B)) / w)
    return cL, cH, vmax, wmax


def _beta_ppf(u):
    """Beta(0.867, 3.030) quantile, branch-free (see _beta_ppf_cheb)."""
    cL, cH, vmax, wmax = _beta_ppf_cheb()
    hi = u > _BETA_USPLIT
    u_safe = jnp.clip(u, 0.0, 1.0)
    v = u_safe ** (1.0 / _BETA_A)
    w = (1.0 - u_safe) ** (1.0 / _BETA_B)
    t = jnp.where(hi, w, v)
    xx = jnp.where(hi, 2.0 * w / wmax, 2.0 * v / vmax) - 1.0
    b1 = jnp.zeros_like(u)
    b2 = jnp.zeros_like(u)
    two_x = 2.0 * xx
    for m in range(_BETA_M - 1, 0, -1):
        cm = jnp.where(hi, cH[m], cL[m]).astype(u.dtype)
        b1, b2 = cm + two_x * b1 - b2, b1
    c0 = jnp.where(hi, cH[0], cL[0]).astype(u.dtype)
    series = c0 + xx * b1 - b2
    return jnp.clip(jnp.where(hi, 1.0 - t * series, t * series), 0.0, 1.0)


def sample_ecc(x, planet: bool, P_orb):
    """Eccentricities. planet: Beta(0.867,3.030) inverse CDF (gather-free
    Chebyshev form); binary: powerlaw exponent 0.2 if P_orb<=10 else 0.6.
    P_orb may be a traced scalar (mean period)."""
    x = jnp.asarray(x)
    if planet:
        return _beta_ppf(x)
    exponent = jnp.where(jnp.asarray(P_orb) <= 10.0, 1.0 / 0.2, 1.0 / 0.6)
    return x ** exponent


# ---------------------------------------------------------------------------
# Mass ratios
# ---------------------------------------------------------------------------

def _q_invcdf_3seg(x, q_min, p1, p2, F_twin):
    """Three-segment broken power law on [q_min, 1] with twin excess.

    Segments: [q_min,0.3] slope p1; [0.3,0.95] slope p2; [0.95,1] slope p2
    scaled by the twin factor A2 (reference priors.py:177-244, 286-353).
    """
    A1 = (0.3**p1) / (0.3**p2)
    A2 = (1 + F_twin / (1 - F_twin)
          * ((1.0 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1))
          / ((1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)))
    I1 = (0.3 ** (p1 + 1) - q_min ** (p1 + 1)) / (p1 + 1)
    I2 = A1 * (0.95 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * A1 * (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    Norm = 1.0 / (I1 + I2 + I3)
    seg1 = (x / Norm * (p1 + 1) + q_min ** (p1 + 1)) ** (1.0 / (p1 + 1))
    seg2 = ((x / Norm - I1) * (p2 + 1) / A1 + 0.3 ** (p2 + 1)) ** (1.0 / (p2 + 1))
    seg3 = ((x / Norm - I1 - I2) * (p2 + 1) / (A1 * A2)
            + 0.95 ** (p2 + 1)) ** (1.0 / (p2 + 1))
    return jnp.where(x <= Norm * I1, seg1,
                     jnp.where(x <= Norm * (I1 + I2), seg2, seg3))


def _q_invcdf_2seg(x, q_min, p2, F_twin):
    """Two-segment variant for 0.1 < M_s < 0.3 (q_min > 0.3)
    (reference priors.py:245-271, 354-380)."""
    A2 = (1 + F_twin / (1 - F_twin)
          * ((1.0 ** (p2 + 1) - q_min ** (p2 + 1)) / (p2 + 1))
          / ((1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)))
    I2 = (0.95 ** (p2 + 1) - q_min ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    Norm = 1.0 / (I2 + I3)
    seg2 = (x / Norm * (p2 + 1) + q_min ** (p2 + 1)) ** (1.0 / (p2 + 1))
    seg3 = ((x / Norm - I2) * (p2 + 1) / A2 + 0.95 ** (p2 + 1)) ** (1.0 / (p2 + 1))
    return jnp.where(x <= Norm * I2, seg2, seg3)


def _sample_q_generic(x, M_s, p1, p2, F_twin):
    x = jnp.asarray(x)
    M_s = jnp.asarray(M_s)
    q_min = 0.1 / jnp.maximum(M_s, 1e-6)
    # M_s >= 1.0: fixed q_min = 0.1 (reference priors.py:177-209)
    big = _q_invcdf_3seg(x, 0.1, p1, p2, F_twin)
    # 0.3 <= M_s < 1.0: q_min = 0.1/M_s, unclipped — the reference keeps
    # the 3-segment formula even when 0.1/M_s slightly exceeds 0.3
    # (priors.py:210-244); clamp only to avoid NaN on inactive lanes.
    mid = _q_invcdf_3seg(x, jnp.minimum(q_min, 0.999), p1, p2, F_twin)
    # 0.1 < M_s < 0.3: 2-segment with q_min = 0.1/M_s (priors.py:245-271)
    small = _q_invcdf_2seg(x, jnp.minimum(q_min, 0.999), p2, F_twin)
    out = jnp.where(M_s >= 1.0, big, jnp.where(M_s >= 0.3, mid, small))
    return jnp.where(M_s <= 0.1, jnp.ones_like(x), out)


def _q_cdf95_3seg(q_min, p1, p2, F_twin):
    """P(q < 0.95) for the 3-segment law (closed form: the inverse CDF's
    segment boundary Norm * (I1 + I2))."""
    A1 = (0.3**p1) / (0.3**p2)
    A2 = (1 + F_twin / (1 - F_twin)
          * ((1.0 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1))
          / ((1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)))
    I1 = (0.3 ** (p1 + 1) - q_min ** (p1 + 1)) / (p1 + 1)
    I2 = A1 * (0.95 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * A1 * (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    return (I1 + I2) / (I1 + I2 + I3)


def _q_cdf95_2seg(q_min, p2, F_twin):
    A2 = (1 + F_twin / (1 - F_twin)
          * ((1.0 ** (p2 + 1) - q_min ** (p2 + 1)) / (p2 + 1))
          / ((1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)))
    I2 = (0.95 ** (p2 + 1) - q_min ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    return I2 / (I2 + I3)


def q_below_twin_cdf(M_s, p1=0.3, p2=-0.5, F_twin=0.30):
    """P(q < 0.95) under ``sample_q``'s law — the twin band's complement
    mass. Used to importance-sample the EBx2P branch on conditioned
    draws: x' = u095 + u * (1 - u095) lands every draw in q >= 0.95 with
    exact ln-weight log(1 - u095). Defaults are sample_q's constants;
    mirrors _sample_q_generic's primary-mass regimes exactly."""
    M_s = jnp.asarray(M_s)
    q_min = 0.1 / jnp.maximum(M_s, 1e-6)
    big = _q_cdf95_3seg(0.1, p1, p2, F_twin)
    mid = _q_cdf95_3seg(jnp.minimum(q_min, 0.999), p1, p2, F_twin)
    small = _q_cdf95_2seg(jnp.minimum(q_min, 0.999), p2, F_twin)
    out = jnp.where(M_s >= 1.0, big, jnp.where(M_s >= 0.3, mid, small))
    # M_s <= 0.1: sample_q returns q = 1 always -> the twin band has all
    # the mass (P(q < 0.95) = 0)
    return jnp.where(M_s <= 0.1, jnp.zeros_like(out), out)


def sample_q(x, M_s):
    """Short-period binary mass ratios (F_twin=0.30, p2=-0.5)."""
    return _sample_q_generic(x, M_s, 0.3, -0.5, 0.30)


def sample_q_companion(x, M_s):
    """Long-period companion mass ratios (F_twin=0.05, p2=-0.95)."""
    return _sample_q_generic(x, M_s, 0.3, -0.95, 0.05)
