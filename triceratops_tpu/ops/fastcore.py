"""Fast likelihood-core internals: per-draw Chebyshev deficit proxy +
per-exposure Kepler solves.

Two exact-to-tolerance algebraic reductions make the chunked cores
compute-light (see ops/lightcurve.py for the cores):

1. **Chebyshev deficit proxy.** For one draw, the occultation deficit is
   a 1-D function D(z) of the sky separation at fixed (k, u1, u2),
   piecewise-smooth on three segments: A = [0, |1-k|] (occulter fully
   inside / fully covering), B1 = [|1-k|, |1-k| + c] and
   B2 = [|1-k| + c, 1+k] (partial overlap), with (contact)^{3/2}
   behavior at the contact points z = |1-k| and z = 1+k. Each segment
   is parametrized by the *symmetric square-root map*

       s = (z - z_lo) / (z_hi - z_lo) in [0, 1],
       x = sqrt(s) - sqrt(1 - s)      in [-1, 1],

   whose inverse s(x) = ((x + sqrt(2 - x^2)) / 2)^2 is analytic with
   double zeros at both endpoints, so every (contact)^{3/2} term becomes
   (double zero)^{3/2} = analytic in x and the Chebyshev series
   converges geometrically instead of ~m^-4. Sampling each segment at
   M Chebyshev-Gauss nodes (in x) and building the series via a DCT
   matmul reduces the per-time-sample cost from a full kernel
   evaluation (~16 quadrature cosines) to two square roots plus a
   2M-flop Clenshaw recurrence. The middle break c = clip(6|1-k|, 0.02,
   half-width) keeps the k ~ 1 twin regime's mirror branch point (at
   z = -|1-k|, which pinches B1's left end as k -> 1) far from the
   segment in mapped coordinates. Measured worst-case absolute deficit
   error over k in [0.01, 1.9] x physical (u1, u2), including the twin
   band k in [0.9, 1.1]: < 8e-7 in f64 at M = 18 (tests/test_fastcore.py;
   the earlier two-segment linear-map scheme was ~1e-4 worst-case in the
   twin band).

2. **Per-exposure Kepler.** The orbit is solved only at 3 points per
   exposure (center and edges) and z^2 is interpolated quadratically
   across the supersamples: z^2(t) is smooth on the ~2-minute exposure
   scale while the flux is not (contact kinks), so supersampling stays
   on the flux as in the reference (likelihoods.py:61) but the
   transcendental-heavy Kepler solve drops ~7x.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..core.kepler import projected_z, z2_taylor
from .occult import occult_quad_deficit

M_CHEB = 18

# coefficient-stage backend: 'auto' uses the k-tabulated basis matmul for
# f32 (device) inputs and exact per-draw kernel nodes for f64 (reference)
# inputs; 'exact'/'tab' force one. Read once at import (env mutation after
# import would silently miss already-traced programs).
COEFFS_BACKEND = os.environ.get("TRICERATOPS_COEFFS", "auto")

# Chebyshev-Gauss nodes theta_j = (j + 1/2) pi / M; DCT-II matrix rows
# give series coefficients c_m = (2/M) sum_j f(x_j) cos(m theta_j),
# with c_0 halved (so f(x) = sum_m c_m T_m(x) directly in Clenshaw).
_theta = (np.arange(M_CHEB) + 0.5) * np.pi / M_CHEB
_CHEB_X = np.cos(_theta)                                  # node positions
_DCT = (2.0 / M_CHEB) * np.cos(np.outer(np.arange(M_CHEB), _theta))
_DCT[0] *= 0.5
_DCT_T = np.ascontiguousarray(_DCT.T)                     # (M, M) f64 master
# node positions in the segment coordinate s in [0, 1]: the inverse of
# the symmetric sqrt map x = sqrt(s) - sqrt(1-s) at the Chebyshev nodes
_S_NODES = (((_CHEB_X + np.sqrt(2.0 - _CHEB_X**2)) / 2.0) ** 2)

# middle-segment break: c = clip(_BREAK_SLOPE * |1-k|, _BREAK_FLOOR,
# (zmax - zsplit)/2); tuned so the worst-case proxy error stays < 8e-7
# over k in [0.01, 1.9] (see module docstring).
_BREAK_SLOPE = 6.0
_BREAK_FLOOR = 0.02


def cheb_deficit_coeffs(k, u1, u2):
    """Per-draw Chebyshev series of D(z) on the three z-segments, each
    under the symmetric sqrt map.

    Args: k, u1, u2 with shape (chunk,).
    Returns (cA, cB1, cB2, zsplit, zmid, invA, invB1, invB2):
    coefficient arrays (chunk, M) and the segment maps
    s = (z - z_lo) * inv, x = sqrt(s) - sqrt(1 - s).
    """
    k = k[:, None]
    zsplit = jnp.abs(1.0 - k)                 # inner contact
    zmax = 1.0 + k
    c = jnp.clip(_BREAK_SLOPE * zsplit, _BREAK_FLOOR, (zmax - zsplit) / 2.0)
    zmid = zsplit + c
    wA = jnp.maximum(zsplit, 1e-6)
    # width floors: at k == 0, c collapses to 0 and invB1/invB2 would be
    # inf -> NaN deficits for z >= zsplit. Degenerate draws are normally
    # masked upstream, but an unmasked k = 0 lane must stay finite.
    wB1 = jnp.maximum(c, 1e-6)
    wB2 = jnp.maximum(zmax - zmid, 1e-6)
    dtype = jnp.result_type(k.dtype, jnp.float32)
    s = jnp.asarray(_S_NODES, dtype)[None, :]
    zA = wA * s
    zB1 = zsplit + wB1 * s
    zB2 = zmid + wB2 * s
    u1b, u2b = u1[:, None], u2[:, None]
    DA = occult_quad_deficit(k, zA, u1b, u2b)
    DB1 = occult_quad_deficit(k, zB1, u1b, u2b)
    DB2 = occult_quad_deficit(k, zB2, u1b, u2b)
    dct = jnp.asarray(_DCT_T, DA.dtype)
    hi = jax.lax.Precision.HIGHEST  # no TF32: the deficit budget is 8e-7
    cA = jnp.dot(DA, dct, precision=hi, preferred_element_type=DA.dtype)
    cB1 = jnp.dot(DB1, dct, precision=hi, preferred_element_type=DA.dtype)
    cB2 = jnp.dot(DB2, dct, precision=hi, preferred_element_type=DA.dtype)
    return (cA, cB1, cB2, zsplit[:, 0], zmid[:, 0], 1.0 / wA[:, 0],
            1.0 / wB1[:, 0], 1.0 / wB2[:, 0])


# ---------------------------------------------------------------------------
# k-tabulated basis coefficients (coeffs-v2)
#
# The DCT above is linear and D = (c0*A0 + c1*A1 + c2*J)/(pi*omega) with
# (c0,c1,c2,omega) functions of (u1,u2) only, so the per-segment Chebyshev
# coefficients of the basis integrals A0, A1, J depend only on k. They are
# pre-tabulated (tools/build_cheb_k_tables.py) as piecewise Chebyshev
# series in a mapped k variable over 8 k-segments (kinks of the middle-
# break clip at 6/7, 1 -/+ 1/300, 7/6; sqrt-resolved maps into the k = 1
# contact degeneracy), k^2-normalized so small-k rows stay O(1). The
# per-draw stage then collapses from 54 exact kernel node evaluations
# (~600 quadrature cosines + contact atan2s per draw) to one Chebyshev-
# in-kappa recurrence plus a (N, sum_degs) @ (sum_degs, 162) matmul.
# Measured worst-case deficit error vs exact-node coefficients: 7.7e-8
# (f64, over k x z x the LDC-grid (u1,u2) extremes), an order below the
# 8e-7 proxy truncation budget.
# ---------------------------------------------------------------------------

_TAB = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "data", "cheb_k_tables.npz"))
_TAB_BREAKS = _TAB["breaks"]          # (9,)
_TAB_KINDS = _TAB["kinds"]            # (8,) 0 affine, 1 log, 2/3 sqrt hi/lo
_TAB_DEGS = _TAB["degs"]              # (8,)
_TAB_C64 = _TAB["C"]                  # (sum_degs, 162)
_TAB_MAXDEG = int(_TAB_DEGS.max())


def _tab_kappa_onehot(kc):
    """Mapped Chebyshev variable of the active k-segment + per-segment
    one-hot masks. kc must already be clipped to the table range."""
    kappa = jnp.zeros_like(kc)
    actives = []
    logk = jnp.log(kc)
    for g in range(8):
        lo, hi = _TAB_BREAKS[g], _TAB_BREAKS[g + 1]
        kind = int(_TAB_KINDS[g])
        if kind == 0:
            t = (kc - lo) / (hi - lo)
        elif kind == 1:
            t = (logk - np.log(lo)) / (np.log(hi) - np.log(lo))
        elif kind == 2:   # sqrt-resolved toward hi
            t = 1.0 - jnp.sqrt(jnp.maximum(hi - kc, 0.0) / (hi - lo))
        else:             # sqrt-resolved toward lo
            t = jnp.sqrt(jnp.maximum(kc - lo, 0.0) / (hi - lo))
        active = (kc >= lo) & ((kc <= hi) if g == 7 else (kc < hi))
        kap = jnp.clip(2.0 * t - 1.0, -1.0, 1.0)
        kappa = jnp.where(active, kap, kappa)
        actives.append(active)
    return kappa, actives


def cheb_deficit_coeffs_tab(k, u1, u2):
    """Drop-in replacement for :func:`cheb_deficit_coeffs` evaluating the
    pre-tabulated basis-coefficient functions of k (one matmul per
    chunk instead of 54 exact kernel node evaluations per draw)."""
    dtype = jnp.result_type(k.dtype, jnp.float32)
    kc = jnp.clip(k, _TAB_BREAKS[0], _TAB_BREAKS[-1]).astype(dtype)
    kappa, actives = _tab_kappa_onehot(kc)

    # Chebyshev basis T_m(kappa), m < maxdeg, then the zero-padded
    # segment-major design row (N, sum_degs)
    T = [jnp.ones_like(kappa), kappa]
    two_k = 2.0 * kappa
    for _ in range(2, _TAB_MAXDEG):
        T.append(two_k * T[-1] - T[-2])
    T = jnp.stack(T, axis=1)                                  # (N, maxdeg)
    cols = [T[:, : int(_TAB_DEGS[g])] * actives[g][:, None].astype(dtype)
            for g in range(8)]
    Tfull = jnp.concatenate(cols, axis=1)                     # (N, sum_degs)
    C = jnp.asarray(_TAB_C64, dtype)
    bas = jnp.dot(Tfull, C, precision=jax.lax.Precision.HIGHEST,
                  preferred_element_type=dtype)               # (N, 162)
    bas = bas.reshape(-1, 3, M_CHEB, 3)

    om = 1.0 - u1 / 3.0 - u2 / 6.0
    # the tabulated basis rows are [A0, A1, J] / (pi * k^2) (the probe
    # inversion in tools/build_cheb_k_tables.py absorbs the 1/pi)
    scale = jnp.minimum(k, _TAB_BREAKS[-1]).astype(dtype) ** 2 / om
    w = jnp.stack([(1.0 - u1 - 2.0 * u2) * scale,
                   (u1 + 2.0 * u2) * scale,
                   u2 * scale], axis=-1)                      # (N, 3)
    coeffs = jnp.sum(bas * w[:, None, None, :], axis=-1)      # (N, 3, M)
    cA, cB1, cB2 = coeffs[:, 0], coeffs[:, 1], coeffs[:, 2]

    kcol = k[:, None]
    zsplit = jnp.abs(1.0 - kcol)
    zmax = 1.0 + kcol
    c = jnp.clip(_BREAK_SLOPE * zsplit, _BREAK_FLOOR, (zmax - zsplit) / 2.0)
    zmid = zsplit + c
    wA = jnp.maximum(zsplit, 1e-6)
    wB1 = jnp.maximum(c, 1e-6)
    wB2 = jnp.maximum(zmax - zmid, 1e-6)
    return (cA, cB1, cB2, zsplit[:, 0], zmid[:, 0], 1.0 / wA[:, 0],
            1.0 / wB1[:, 0], 1.0 / wB2[:, 0])


def deficit_coeffs(k, u1, u2):
    """Backend dispatcher: tabulated for f32 device math, exact kernel
    nodes for f64 reference math (or force via TRICERATOPS_COEFFS)."""
    if COEFFS_BACKEND == "exact":
        return cheb_deficit_coeffs(k, u1, u2)
    if COEFFS_BACKEND == "tab":
        return cheb_deficit_coeffs_tab(k, u1, u2)
    if jnp.result_type(k, u1, u2) == jnp.float64:
        return cheb_deficit_coeffs(k, u1, u2)
    return cheb_deficit_coeffs_tab(k, u1, u2)


def _clenshaw_select3(cA, cB1, cB2, in_B1, in_B2, x):
    """One Clenshaw pass with per-point segment selection: the recurrence
    coefficient at each step is the active segment's. Exactly equal to
    evaluating all three series and selecting, at ~1/3 the cost."""
    b1 = jnp.zeros_like(x)
    b2 = jnp.zeros_like(x)
    two_x = 2.0 * x
    for m in range(M_CHEB - 1, 0, -1):
        cm = jnp.where(in_B2, cB2[:, m][:, None],
                       jnp.where(in_B1, cB1[:, m][:, None],
                                 cA[:, m][:, None]))
        b1, b2 = cm + two_x * b1 - b2, b1
    c0 = jnp.where(in_B2, cB2[:, 0][:, None],
                   jnp.where(in_B1, cB1[:, 0][:, None], cA[:, 0][:, None]))
    return c0 + x * b1 - b2


def cheb_deficit_eval(coeffs, z):
    """D(z) from cheb_deficit_coeffs output; z: (chunk, P)."""
    cA, cB1, cB2, zsplit, zmid, invA, invB1, invB2 = coeffs
    zs = zsplit[:, None]
    zm = zmid[:, None]
    in_B2 = z >= zm
    in_B1 = (z >= zs) & ~in_B2
    s = jnp.where(in_B2, (z - zm) * invB2[:, None],
                  jnp.where(in_B1, (z - zs) * invB1[:, None],
                            z * invA[:, None]))
    s = jnp.clip(s, 0.0, 1.0)
    x = jnp.sqrt(s) - jnp.sqrt(1.0 - s)
    D = _clenshaw_select3(cA, cB1, cB2, in_B1, in_B2, x)
    return jnp.clip(D, 0.0, 1.0)


def exposure_z2_poly(t_exp, h, P, a_R, inc, e, w):
    """Quadratic (Taylor) model of z^2 over each exposure from ONE
    Kepler solve with closed-form orbital derivatives (core/kepler.py
    z2_taylor).

    t_exp: (n_t,) exposure centers; h: half exposure length (unused by
    the Taylor form, kept for signature stability). Per-draw orbital
    parameters shaped (chunk,). Returns (q0, q1, q2, front) with shapes
    (chunk, n_t): z^2(t_exp + d) ~= q0 + q1 d + q2 d^2.
    """
    del h
    te = t_exp[None, :]
    args = (P[:, None], a_R[:, None], inc[:, None], e[:, None], w[:, None])
    z2, dz2, d2z2, front = z2_taylor(te, 0.0, *args)
    return z2, dz2, 0.5 * d2z2, front


def z_supersampled(q0, q1, q2, offsets):
    """z at supersample offsets from the quadratic z^2 model.

    q*: (chunk, n_t); offsets: (ns,). Returns (chunk, ns, n_t)."""
    d = offsets[None, :, None]
    q0e, q1e, q2e = q0[:, None, :], q1[:, None, :], q2[:, None, :]
    z2 = q0e + q1e * d + q2e * d * d
    return jnp.sqrt(jnp.maximum(z2, 0.0))
