"""Mass -> (radius, Teff) and mass -> flux-ratio relations, device-ready.

The reference builds scipy ``InterpolatedUnivariateSpline``s over published
node tables (Torres et al. relations for M > 0.63 Msun, a cool-dwarf
relation below; band-wise flux splines) and evaluates them per draw on the
host (reference: triceratops/funcs.py:19-140). Here the cubic splines are
converted once to piecewise-polynomial (breakpoint + coefficient) arrays
so evaluation is a searchsorted gather + Horner step that runs on device
inside the jitted MC program. Host (NumPy) evaluation uses scipy directly
and is bitwise-equal to the reference path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.interpolate import InterpolatedUnivariateSpline, PPoly

import jax.numpy as jnp

# Node tables (reference: triceratops/funcs.py:19-51, 81-119)
MASS_NODES_TORRES = np.array([
    0.26, 0.47, 0.59, 0.69, 0.87, 0.98, 1.085,
    1.4, 1.65, 2.0, 2.5, 3.0, 4.4, 15.0, 40.0])
TEFF_NODES_TORRES = np.array([
    3170, 3520, 3840, 4410, 5150, 5560, 5940, 6650,
    7300, 8180, 9790, 11400, 15200, 30000, 42000])
RAD_NODES_TORRES = np.array([
    0.28, 0.47, 0.60, 0.72, 0.9, 1.05, 1.2, 1.55,
    1.8, 2.1, 2.4, 2.6, 3.0, 6.2, 11.0])
MASS_NODES_CDWRF = np.array([0.1, 0.135, 0.2, 0.35, 0.48, 0.58, 0.63])
TEFF_NODES_CDWRF = np.array([2800, 3000, 3200, 3400, 3600, 3800, 4000])
RAD_NODES_CDWRF = np.array([0.12, 0.165, 0.23, 0.36, 0.48, 0.585, 0.6])

FLUX_NODES = {
    "TESS": (np.array([0.1, 0.15, 0.23, 0.4, 0.58, 0.7, 0.9, 1.15, 1.45, 2.2, 2.8]),
             np.array([-3, -2.5, -2, -1.5, -1, -0.5, 0, 0.5, 1, 1.5, 2], dtype=float)),
    "J": (np.array([0.1, 0.2, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3]),
          np.array([-5.7, -3.8, -1.6, 0, 1.2, 2.9, 3.3, 4, 6]) / 2.5),
    "H": (np.array([0.1, 0.23, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3]),
          np.array([-4.9, -2.8, -0.9, 0.6, 1.5, 3, 3.3, 4, 6]) / 2.5),
    "K": (np.array([0.1, 0.2, 0.35, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3]),
          np.array([-4.7, -2.9, -1.7, -0.7, 0.6, 1.6, 3, 3.3, 4, 6]) / 2.5),
}
FLUX_NODES["Vis"] = FLUX_NODES["TESS"]


@lru_cache(maxsize=None)
def _spline(name: str):
    if name == "torres_teff":
        return InterpolatedUnivariateSpline(MASS_NODES_TORRES, TEFF_NODES_TORRES)
    if name == "torres_rad":
        return InterpolatedUnivariateSpline(MASS_NODES_TORRES, RAD_NODES_TORRES)
    if name == "cdwrf_teff":
        return InterpolatedUnivariateSpline(MASS_NODES_CDWRF, TEFF_NODES_CDWRF)
    if name == "cdwrf_rad":
        return InterpolatedUnivariateSpline(MASS_NODES_CDWRF, RAD_NODES_CDWRF)
    m, f = FLUX_NODES[name]
    return InterpolatedUnivariateSpline(m, f)


@lru_cache(maxsize=None)
def _ppoly_arrays(name: str):
    """(breaks, coefs) float32 arrays for device piecewise-cubic eval."""
    spl = _spline(name)
    pp = PPoly.from_spline(spl._eval_args, extrapolate=True)
    return (np.asarray(pp.x, dtype=np.float64),
            np.asarray(pp.c, dtype=np.float64))


def ppoly_eval_jnp(x, breaks, coefs):
    """Evaluate a scipy PPoly (breaks (n,), coefs (k, n-1)) with jnp.

    breaks/coefs must be host numpy arrays (trace-time constants): the
    interval index is a comparison sum and the per-interval coefficients
    are nested scalar selects — no searchsorted, no gather. The former
    searchsorted + table-gather form was slow under vmap (XLA lowers
    batched small-table gathers poorly), while select chains over <= 15
    trace-time constants vectorize identically in every context."""
    breaks = np.asarray(breaks)
    coefs = np.asarray(coefs)
    n_int = coefs.shape[1]
    inner = breaks[1:-1]
    idx = jnp.zeros_like(x, dtype=jnp.int32)
    for b in inner:
        idx = idx + (x >= float(b)).astype(jnp.int32)

    def sel(table):
        out = jnp.full_like(x, float(table[n_int - 1]))
        for i in range(n_int - 2, -1, -1):
            out = jnp.where(idx == i, float(table[i]), out)
        return out

    dx = x - sel(breaks[:-1])
    out = sel(coefs[0])
    for j in range(1, coefs.shape[0]):
        out = out * dx + sel(coefs[j])
    return out


class SplineDevice:
    """Piecewise cubic for one named relation, jit-safe.

    Breakpoints/coefficients are held as host numpy arrays and embedded as
    constants at trace time (creating jnp arrays lazily inside a jit trace
    would leak tracers through the lru_cache)."""

    def __init__(self, name: str, dtype=np.float32):
        breaks, coefs = _ppoly_arrays(name)
        self.breaks = np.asarray(breaks, dtype=dtype)
        self.coefs = np.asarray(coefs, dtype=dtype)

    def __call__(self, x):
        return ppoly_eval_jnp(x, self.breaks, self.coefs)


@lru_cache(maxsize=None)
def spline_device(name: str) -> SplineDevice:
    return SplineDevice(name)


# ---------------------------------------------------------------------------
# Public relations. `xp=np` gives the host/scipy path (parity with the
# reference); `xp=jnp` uses the device PPoly evaluation under jit.
# ---------------------------------------------------------------------------

def stellar_relations(masses, max_radii, max_teffs, xp=np):
    """Radii and Teffs from masses, clamped (reference funcs.py:54-79)."""
    if xp is np:
        masses = np.asarray(masses, dtype=float)
        radii = np.where(masses > 0.63,
                         _spline("torres_rad")(masses),
                         _spline("cdwrf_rad")(masses))
        teffs = np.where(masses > 0.63,
                         _spline("torres_teff")(masses),
                         _spline("cdwrf_teff")(masses))
    else:
        radii = jnp.where(masses > 0.63,
                          spline_device("torres_rad")(masses),
                          spline_device("cdwrf_rad")(masses))
        teffs = jnp.where(masses > 0.63,
                          spline_device("torres_teff")(masses),
                          spline_device("cdwrf_teff")(masses))
    radii = xp.minimum(radii, max_radii)
    teffs = xp.minimum(teffs, max_teffs)
    radii = xp.maximum(radii, 0.1)
    teffs = xp.maximum(teffs, 2800.0)
    return radii, teffs


def flux_relation(masses, filt: str = "TESS", xp=np):
    """Flux ratio vs a ~1 Msun star (reference funcs.py:121-140)."""
    name = "TESS" if filt in ("TESS", "Vis") else filt
    if xp is np:
        return 10.0 ** _spline(name)(np.asarray(masses, dtype=float))
    return 10.0 ** spline_device(name)(masses)
