"""triceratops_tpu — accelerator-native Bayesian vetting of
transiting-planet candidates.

A from-scratch JAX/XLA reimplementation of the TRICERATOPS
framework (Giacalone et al. 2021, AJ 161, 24): given a phase-folded
transit light curve and the star field around the target, it
Monte-Carlo-marginalizes the likelihood of ~15-20 astrophysical scenarios
and reports FPP (false-positive probability) and NFPP (nearby FPP).

Usage mirrors the reference package::

    import triceratops_tpu.triceratops as tr
    target = tr.target(ID, sectors)            # online
    target = tr.target.from_stars(stars_df)    # offline
    target.calc_depths(tdepth)
    target.calc_probs(time, flux, flux_err, P_orb)
    target.FPP, target.NFPP
"""

import os as _os

import jax as _jax


def compilation_cache_dir(environ=_os.environ):
    """Directory this package points JAX's persistent compilation cache
    at: None when JAX_COMPILATION_CACHE_DIR is set (JAX reads that
    itself), else one fixed directory inside the checkout, so that every
    process of a checkout shares compiled programs."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


_cache_dir = compilation_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .frontend.target import target  # noqa: F401
from .scenarios.api import (  # noqa: F401
    lnZ_TTP, lnZ_TEB, lnZ_PTP, lnZ_PEB, lnZ_STP, lnZ_SEB,
    lnZ_DTP, lnZ_DEB, lnZ_BTP, lnZ_BEB,
    lnZ_NTP_unknown, lnZ_NEB_unknown, lnZ_NTP_evolved, lnZ_NEB_evolved,
)

__version__ = "0.1.0"
