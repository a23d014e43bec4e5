"""Quadratic limb-darkened occultation kernel (branch-free, vectorized).

Computes the flux *deficit* D(p, z) of a star of unit radius with quadratic
limb darkening I(r) = 1 - u1(1-mu) - u2(1-mu)^2, mu = sqrt(1-r^2), occulted
by an opaque disk of radius ``p`` whose center is at sky-projected distance
``z`` (both in stellar radii). The transit light curve is F = 1 - D.

This replaces the PyTransit QuadraticModel Mandel-Agol kernel used by the
reference (reference: triceratops/likelihoods.py:24-25, 61-71) with a
formulation designed for wide SIMD hardware:

Decompose I(r) = (1-u1-2u2) + (u1+2u2)*sqrt(1-r^2) + u2*r^2 - ... more
precisely

    D = [ (1-u1-2u2)*A0 + (u1+2u2)*A1 + u2*J ] / (pi * (1 - u1/3 - u2/6))

where, over the lens-shaped overlap region of the two disks,

    A0 = area,   A1 = integral of sqrt(1-r^2),   J = integral of r^2.

By Green's theorem with radial potentials T(r) (div(T(r) r_hat) = f(r)),
each integral splits into a star-boundary arc term plus an integral over
the occulter-boundary arc eta in [eta0, pi] (eta measured on the occulter
circle from the point farthest from the star center):

    A0 = kappa1     + 2p * Int (1/2) * (z cos(eta) + p) deta          (exact)
    J  = kappa1 / 2 + 2p * Int (r^2/4) * (z cos(eta) + p) deta        (exact)
    A1 = (2/3) kappa1 + 2p * Int G(r^2) * (z cos(eta) + p) deta       (GL quad)

with r^2(eta) = z^2 + p^2 + 2 z p cos(eta), G(s) = (1-(1-s)^{3/2})/(3s)
(analytic in s, G(0)=1/2), kappa1 = half-angle of the star-boundary arc
inside the occulter and eta0 the occulter-arc entry angle. Both angles are
evaluated in cancellation-free atan2 form. The A1 integrand is analytic in
eta after the endpoint-regularizing substitution eta = eta0 +
(pi-eta0) sin^2(t), so fixed-order Gauss-Legendre converges exponentially;
32 nodes give < 1e-7 absolute error in D (validated in
tests/test_occult.py against adaptive quadrature).

All operations are elementwise, branch-free (where/clamp only), and
f32-safe: no elliptic-integral case table, no z ~ p or z ~ 1-p special
cases. The eta0 = pi limit automatically yields D = 0 out of transit and
the kappa1 = pi limit yields total occultation.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Gauss-Legendre nodes for the A1 quadrature, precomputed on [0, pi/2] for
# the substitution eta = eta0 + (pi - eta0) sin^2(t). The order is
# dtype-dependent (static at trace time): 16 nodes match the scipy
# reference to 6e-11 in f64; the f32 device path uses 11 nodes, whose
# 2.2e-8 worst-case deficit error (measured in f64 over k in [0.01,1.9]
# x z at the LDC-grid-worst limb darkening (u1,u2)=(0.205,0.489) — the
# quadrature error scales with |u1+2u2|/omega, maximized over both
# bundled mission grids) sits below f32 round-off accumulation and well
# under the 8e-7 Chebyshev-proxy budget, saving 5/16 of the quadrature
# transcendentals in the per-draw coefficient stage. (10 nodes measured
# 1.35e-7 worst-case at the same point — still within budget, but 11
# buys a sub-1e-7 bound for ~1 extra node of work.)
_N_GL = 16          # float64 / reference-accuracy order
_N_GL_F32 = 11      # float32 device-path order


def _gl_tables(n):
    gl_x, gl_w = np.polynomial.legendre.leggauss(n)
    gl_t = (np.pi / 4.0) * (gl_x + 1.0)        # t_k in (0, pi/2)
    sin2t = np.sin(gl_t) ** 2                  # sin^2(t_k)
    weight = (np.pi / 4.0) * gl_w * np.sin(2.0 * gl_t)  # w_k * deta/dt / (pi-eta0)
    return sin2t, weight


_GL_SIN2T, _GL_WEIGHT = _gl_tables(_N_GL)
_GL_SIN2T_F32, _GL_WEIGHT_F32 = _gl_tables(_N_GL_F32)


def _stable_angle(num1, num2, cos_2x):
    """atan2-form angle in [0, pi] with cancellation-free sine.

    Returns atan2(sqrt(max(num1,0)*max(num2,0)), cos_2x) where
    num1*num2 = (2x)^2 sin^2(angle) and cos_2x = (2x) cos(angle) for the
    appropriate scale 2x > 0. Clamped products give exact 0 / pi limits.
    """
    s = jnp.sqrt(jnp.maximum(num1, 0.0) * jnp.maximum(num2, 0.0))
    return jnp.arctan2(s, cos_2x)


def occult_quad_deficit(p, z, u1, u2):
    """Flux deficit D(p, z) for quadratic limb darkening. Broadcasts.

    Args:
        p: occulter/star radius ratio (>0).
        z: sky-projected center distance in stellar radii (>=0).
        u1, u2: quadratic limb-darkening coefficients.
    Returns:
        D with F = 1 - D (0 out of transit, (1 - under-occulter flux)
        fraction in transit, total-flux fraction when fully occulted).
    """
    p = jnp.asarray(p)
    z = jnp.abs(jnp.asarray(z))
    # keep out-of-transit z tame so r^2 etc. stay small; deficit -> 0 anyway
    z = jnp.minimum(z, 1.0 + p + 1.0)

    zp2m = 1.0 - (z - p) ** 2          # (1-(z-p)^2)
    zp2p = (z + p) ** 2 - 1.0          # ((z+p)^2-1)

    # kappa1: star-boundary arc half-angle inside the occulter.
    #   cos k1 = (z^2+1-p^2)/(2z); sin k1 = sqrt((p^2-(z-1)^2)((z+1)^2-p^2))/(2z)
    kappa1 = _stable_angle(
        p**2 - (z - 1.0) ** 2, (z + 1.0) ** 2 - p**2, z**2 + 1.0 - p**2
    )
    # eta0: occulter-boundary arc entry angle.
    #   cos e0 = (1-z^2-p^2)/(2zp); sin e0 = sqrt(((z+p)^2-1)(1-(z-p)^2))/(2zp)
    eta0 = _stable_angle(zp2p, zp2m, 1.0 - z**2 - p**2)

    d_eta = jnp.pi - eta0
    sin_eta0 = jnp.sin(eta0)
    cos_eta0 = jnp.cos(eta0)

    # --- A0: overlap area (exact) ---------------------------------------
    # Int_{eta0}^{pi} (z cos + p) deta = -z sin(eta0) + p (pi - eta0)
    A0 = kappa1 + p * (p * d_eta - z * sin_eta0)

    # --- J: integral of r^2 over the lens (exact) ------------------------
    # Int (r^2/4)(z cos + p) deta with r^2 = z^2+p^2+2zp cos:
    #   = (1/4)[ ((z^2+p^2) z + 2 z p^2) * (-sin e0)
    #            + (z^2+p^2) p (pi-e0)
    #            + 2 z^2 p ((pi-e0)/2 - sin e0 cos e0 / 2) ]
    zz_pp = z**2 + p**2
    J = kappa1 / 2.0 + (2.0 * p / 4.0) * (
        -(zz_pp * z + 2.0 * z * p**2) * sin_eta0
        + zz_pp * p * d_eta
        + 2.0 * z**2 * p * (d_eta / 2.0 - sin_eta0 * cos_eta0 / 2.0)
    )

    # --- A1: integral of sqrt(1-r^2) (Gauss-Legendre over analytic f) ----
    # eta_k = eta0 + (pi-eta0) sin^2(t_k); quadrature weight includes
    # deta/dt = (pi-eta0) sin(2 t_k).
    dtype = p.dtype if p.dtype.kind == "f" else jnp.float32
    if dtype == jnp.float64:
        sin2t = jnp.asarray(_GL_SIN2T, dtype=dtype)
        wgt = jnp.asarray(_GL_WEIGHT, dtype=dtype)
    else:
        sin2t = jnp.asarray(_GL_SIN2T_F32, dtype=dtype)
        wgt = jnp.asarray(_GL_WEIGHT_F32, dtype=dtype)
    # shape (..., N_GL)
    eta_k = eta0[..., None] + d_eta[..., None] * sin2t
    cos_k = jnp.cos(eta_k)
    r2 = z[..., None] ** 2 + p[..., None] ** 2 + 2.0 * z[..., None] * p[..., None] * cos_k
    one_m = jnp.maximum(1.0 - r2, 0.0)
    # G(s) = (1-(1-s)^{3/2})/(3s), smooth; series for small s to avoid 0/0
    s_safe = jnp.where(r2 > 1e-3, r2, 1.0)
    G_big = (1.0 - one_m * jnp.sqrt(one_m)) / (3.0 * s_safe)
    # (1-(1-s)^1.5)/(3s) = 1/2 - s/8 + s^2/48 + O(s^3)
    G_small = 0.5 - r2 / 8.0 + r2 * r2 / 48.0
    G = jnp.where(r2 > 1e-3, G_big, G_small)
    integrand = G * (z[..., None] * cos_k + p[..., None])
    A1 = (2.0 / 3.0) * kappa1 + 2.0 * p * d_eta * jnp.sum(wgt * integrand, axis=-1)

    omega = 1.0 - u1 / 3.0 - u2 / 6.0
    D = ((1.0 - u1 - 2.0 * u2) * A0 + (u1 + 2.0 * u2) * A1 + u2 * J) / (jnp.pi * omega)
    return jnp.clip(D, 0.0, 1.0)


def occult_quad_flux(p, z, u1, u2):
    """Normalized flux F = 1 - D (convenience wrapper)."""
    return 1.0 - occult_quad_deficit(p, z, u1, u2)


# ---------------------------------------------------------------------------
# Host-side brute-force reference (float64, slow) used by the test suite to
# anchor the kernel. Independent derivation path: direct radial integration
# of the ring-overlap angle. Not used on the compute path.
# ---------------------------------------------------------------------------

def occult_quad_deficit_reference(p: float, z: float, u1: float, u2: float) -> float:
    """High-accuracy deficit via adaptive radial quadrature (host, f64)."""
    from scipy.integrate import quad

    z = abs(float(z))
    p = float(p)
    if z >= 1.0 + p:
        return 0.0
    omega = 1.0 - u1 / 3.0 - u2 / 6.0

    def intensity(r):
        mu = np.sqrt(max(1.0 - r * r, 0.0))
        return 1.0 - u1 * (1.0 - mu) - u2 * (1.0 - mu) ** 2

    def kappa(r):
        # half-angle of the ring of radius r inside the occulter
        if r <= p - z:
            return np.pi
        if r >= z + p or r <= z - p:
            return 0.0
        c = (z * z + r * r - p * p) / (2.0 * z * r)
        return np.arccos(np.clip(c, -1.0, 1.0))

    def f(r):
        return 2.0 * kappa(r) * intensity(r) * r

    lo = max(z - p, 0.0)
    hi = min(z + p, 1.0)
    if hi <= 0.0:
        return 0.0
    # integrate piecewise with breakpoints at |z-p| and p-z
    pts = sorted({lo, hi, min(max(abs(z - p), lo), hi)})
    total = 0.0
    # full-ring part when p > z
    if p > z:
        r_full = min(p - z, 1.0)
        total += quad(lambda r: 2.0 * np.pi * intensity(r) * r, 0.0, r_full,
                      limit=200)[0]
        lo = min(r_full, hi)
    segs = [s for s in pts if lo <= s <= hi]
    segs = sorted(set([lo, hi] + segs))
    for a_, b_ in zip(segs[:-1], segs[1:]):
        if b_ > a_:
            total += quad(f, a_, b_, limit=400)[0]
    return total / (np.pi * omega)
