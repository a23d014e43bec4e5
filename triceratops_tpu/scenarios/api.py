"""Public scenario-evidence API: the 14 ``lnZ_*`` functions.

Signatures, semantics, and returned best-fit dictionaries mirror the
reference's ``triceratops.marginal_likelihoods`` module
(reference: marginal_likelihoods.py:39-3178); the computation is the
vectorized JAX engine (keyed RNG -> jitted sampling -> chunked transit
kernel -> on-device evidence reduction). ``parallel`` is accepted for signature
compatibility and ignored: there is only the vectorized path, which
eliminates the reference's parallel-vs-serial mask-parity bug class by
construction (SURVEY.md section 5.2).

Every function accepts an optional ``key`` (jax PRNG key). When omitted a
fresh key is derived from numpy's global RNG so ``np.random.seed`` gives
reproducibility, like the reference's global-stream behavior.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import G, MSUN, RSUN
from ..funcs import file_to_contrast_curve, trilegal_results
from ..populations.ldc import lookup_target, grid_at_Z, lookup_stars
from ..populations.molusc import load_molusc_qs
from ..ops import lightcurve
from ..ops.lightcurve import lnL_planet, lnL_eb
from . import engine as eng

F32 = np.float32
N_SAMPLES = eng.N_SAMPLES

__all__ = [
    "lnZ_TTP", "lnZ_TEB", "lnZ_PTP", "lnZ_PEB", "lnZ_STP", "lnZ_SEB",
    "lnZ_DTP", "lnZ_DEB", "lnZ_BTP", "lnZ_BEB",
    "lnZ_NTP_unknown", "lnZ_NEB_unknown", "lnZ_NTP_evolved",
    "lnZ_NEB_evolved",
]


# ---------------------------------------------------------------------------
# Shared host-side prep
# ---------------------------------------------------------------------------

def _key(key):
    if key is not None:
        return key
    return jax.random.key(int(np.random.randint(0, 2**31 - 1)))


def _p_bounds(P_orb):
    """Scalar P -> (P, P); [P_min, P_max] -> bounds (reference ml.py:67-72)."""
    if isinstance(P_orb, (float, int)):
        return F32(P_orb), F32(P_orb)
    arr = np.asarray(P_orb, dtype=float)
    return F32(arr[0]), F32(arr[-1])


def _cc(contrast_curve_file, filt):
    """(separations, contrasts, cc_filt): defaults ([2.2], [1.0], None)
    when no contrast curve (reference ml.py:484-487)."""
    if contrast_curve_file is None:
        return (np.array([2.2], F32), np.array([1.0], F32), None)
    seps, cons = file_to_contrast_curve(contrast_curve_file)
    return seps.astype(F32), cons.astype(F32), str(filt)


def _lc(time, flux, exptime, nsamples):
    """(time_dev, obs_dev, n_t, chunk) device-ready light-curve arrays."""
    time = np.asarray(time, dtype=np.float64)
    obs_dev = (np.asarray(flux, dtype=np.float64) - 1.0).astype(F32)
    n_t = len(time)
    chunk = lightcurve.draw_chunk(n_t, nsamples)
    return jnp.asarray(time.astype(F32)), jnp.asarray(obs_dev), n_t, chunk


def _logg(M_s, R_s):
    return float(np.log10(G * (M_s * MSUN) / (R_s * RSUN) ** 2))


def _full(v):
    return np.full(N_SAMPLES, v)


def _zeros():
    return np.zeros(N_SAMPLES)


def _gd(d, *names):
    """Pick gather arrays from a sampler output dict."""
    return {n: d[n] for n in names}


def _u_arrays(u1, u2, N):
    """Per-draw limb-darkening arrays, filled on device (a host np.full
    here would ship 8 MB over the interconnect per scenario)."""
    return (jnp.full((N,), np.float32(u1), jnp.float32),
            jnp.full((N,), np.float32(u2), jnp.float32))


def _file_sig(path):
    """(path, mtime_ns, size) — cache key that invalidates when the file
    is rewritten in-process (a same-path rewrite must not serve stale
    device arrays)."""
    st = os.stat(path)
    return (path, st.st_mtime_ns, st.st_size)


def _prep_background(trilegal_fname, Tmag, Jmag, Hmag, Kmag, mission, filt,
                     need_ldc, need_cc_ratio=False):
    return _prep_background_cached(_file_sig(trilegal_fname), Tmag, Jmag,
                                   Hmag, Kmag, mission, filt, need_ldc,
                                   need_cc_ratio)


@lru_cache(maxsize=16)
def _prep_background_cached(file_sig, Tmag, Jmag, Hmag, Kmag, mission, filt,
                            need_ldc, need_cc_ratio=False):
    """Per-background-star device arrays from a TRILEGAL csv
    (reference ml.py:1451-1463 and analogues). Cached per file/target so
    the four D*/B* scenarios share one parse + LDC lookup pass."""
    trilegal_fname = file_sig[0]
    (Tmags, Masses, loggs, Teffs, Zs, Jmags, Hmags, Kmags) = trilegal_results(
        trilegal_fname, Tmag)
    d_T = Tmag - Tmags
    d_J, d_H, d_K = Jmag - Jmags, Hmag - Hmags, Kmag - Kmags
    fluxratios = 10 ** (d_T / 2.5) / (1 + 10 ** (d_T / 2.5))
    if filt == "J":
        delta_band = d_J
    elif filt == "H":
        delta_band = d_H
    elif filt == "K":
        delta_band = d_K
    else:
        delta_band = d_T
    bg = {
        "fluxratios": fluxratios.astype(F32),
        "delta_band": delta_band.astype(F32),
        "masses": Masses.astype(F32),
        "radii": (np.sqrt(G * Masses * MSUN / 10**loggs) / RSUN).astype(F32),
        "loggs": loggs.astype(F32),
        "teffs": Teffs.astype(F32),
    }
    if need_ldc:
        u1s, u2s = lookup_stars(Teffs, loggs, Zs, mission)
        bg["u1s"] = u1s.astype(F32)
        bg["u2s"] = u2s.astype(F32)
    else:
        n = len(Tmags)
        bg["u1s"] = np.zeros(n, F32)
        bg["u2s"] = np.zeros(n, F32)
    if need_cc_ratio:
        fr_band = 10 ** (delta_band / 2.5) / (1 + 10 ** (delta_band / 2.5))
        bg["fluxratios_cc"] = fr_band.astype(F32)
    else:
        bg["fluxratios_cc"] = bg["fluxratios"]
    from ..scenarios.engine import BG_PACK_FIELDS
    bg["pack"] = np.stack([bg[f] for f in BG_PACK_FIELDS], axis=1)
    return {k: jnp.asarray(v) for k, v in bg.items()}, len(Tmags)


def _prep_lookalikes(trilegal_fname, Tmag, mission):
    return _prep_lookalikes_cached(_file_sig(trilegal_fname), Tmag, mission)


@lru_cache(maxsize=16)
def _prep_lookalikes_cached(file_sig, Tmag, mission):
    """Tmag +/- 1 lookalike population for the NTP/NEB-unknown scenarios
    (reference ml.py:2402-2446)."""
    (Tmags, Masses, loggs, Teffs, Zs, _J, _H, _K) = trilegal_results(
        file_sig[0], Tmag)
    m = (Tmag - 1 < Tmags) & (Tmags < Tmag + 1)
    if m.sum() == 0:
        return None, 0
    Masses, loggs, Teffs, Zs = Masses[m], loggs[m], Teffs[m], Zs[m]
    u1s, u2s = lookup_stars(Teffs, loggs, Zs, mission)
    pop = {
        "masses": Masses.astype(F32),
        "radii": (np.sqrt(G * Masses * MSUN / 10**loggs) / RSUN).astype(F32),
        "loggs": loggs.astype(F32),
        "teffs": Teffs.astype(F32),
        "u1s": u1s.astype(F32),
        "u2s": u2s.astype(F32),
    }
    from ..scenarios.engine import POP_PACK_FIELDS
    pop["pack"] = np.stack([pop[f] for f in POP_PACK_FIELDS], axis=1)
    return {k: jnp.asarray(v) for k, v in pop.items()}, int(m.sum())


def _molusc(molusc_file, M_s, N):
    if molusc_file is None:
        return jnp.zeros((N,), jnp.float32), False
    return jnp.asarray(load_molusc_qs(molusc_file, M_s, N).astype(F32)), True


def _res(lnZ, gathered, **fields):
    """Assemble a best-fit result dict. Values may be jax device arrays
    (converted lazily by callers) so scenario dispatches stay async."""
    out = dict(fields)
    out.update(gathered)
    out["lnZ"] = lnZ
    return out


# ---------------------------------------------------------------------------
# Target-star scenarios
# ---------------------------------------------------------------------------

def lnZ_TTP(time, flux, sigma, P_orb, M_s, R_s, Teff, Z,
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, key=None,
            importance_sampling: bool = True):
    """Marginal likelihood of the TTP scenario (reference ml.py:39-172).
    Also used for NTP on nearby stars (reference triceratops.py:1357)."""
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    d = eng.sample_planet_target(_key(key), P_lo, P_hi, F32(M_s), F32(R_s),
                                 N=N, flatpriors=flatpriors,
                               stratified=importance_sampling)
    u1a, u2a = _u_arrays(u1, u2, N)
    lnL = lnL_planet(t_ss, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                     d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                     jnp.ones((N,), jnp.float32), d["mask"],
                     exptime=exptime, n_t=n_t, ns=nsamples, chunk=chunk)
    lnZ, g = eng.run_finalize(lnL, d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs", "argps"))
    return _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                      "R_p": g["rps"], "ecc": g["eccs"], "argp": g["argps"]},
                M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros(),
                fluxratio_comp=_zeros())


def _twin_n(N, importance_sampling, div=None):
    """Twin-branch conditioned draw count: N // TWIN_DIV under importance
    sampling (TWIN_DIV_SEB for SEB via ``div``), 0 (legacy shared draws)
    otherwise (engine module notes)."""
    d = eng.TWIN_DIV if div is None else div
    return max(N // d, 1) if importance_sampling else 0


def _eb_lnZ_pair(d, t_ss, obs_dev, sigma, u1a, u2a, exptime, n_t, ns,
                 chunk):
    """Shared normal+twin EB likelihood computation. The twin branch is
    read uniformly from d['twin'] (a conditioned independent draw set
    under importance sampling, an aliased view of the shared draws
    otherwise — engine module notes)."""
    lnL = lnL_eb(t_ss, obs_dev, sigma, d["k"], d["ksec"], d["P"], d["a_R"],
                 d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                 d["g_pri"], d["g_sec"], d["mask"],
                 exptime=exptime, n_t=n_t, ns=ns, chunk=chunk,
                 apply_veto=True)
    t = d["twin"]
    nt = t["P"].shape[0]
    u1t = t.get("u1s", u1a[:nt])
    u2t = t.get("u2s", u2a[:nt])
    lnL_twin = lnL_eb(t_ss, obs_dev, sigma, t["k"], t["ksec"], 2.0 * t["P"],
                      t["a_R"], t["inc_rad"], t["eccs"], t["w_rad"],
                      u1t, u2t, t["g_pri"], t["g_sec"], t["mask"],
                      exptime=exptime, n_t=n_t, ns=ns, chunk=chunk,
                      apply_veto=False)
    return lnL, lnL_twin


def lnZ_TEB(time, flux, sigma, P_orb, M_s, R_s, Teff, Z,
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, key=None,
            importance_sampling: bool = True):
    """TEB + EBx2P twin (reference ml.py:175-383). Also used for NEB."""
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    d = eng.sample_teb(_key(key), P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       N=N, stratified=importance_sampling,
                       twin_n=_twin_n(N, importance_sampling))
    t = d["twin"]
    u1a, u2a = _u_arrays(u1, u2, N)
    lnL, lnL_twin = _eb_lnZ_pair(d, t_ss, obs_dev, F32(sigma), u1a, u2a,
                                 exptime, n_t, nsamples, chunk)
    gnames = ("P", "incs", "b", "eccs", "argps", "masses", "radii",
              "fluxratios")
    lnZ, g = eng.run_finalize(lnL, d["lnw"], _gd(d, *gnames))
    lnZt, gt = eng.run_finalize(lnL_twin, t["lnw"], _gd(t, *gnames))
    const = dict(M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                 R_p=_zeros(), fluxratio_comp=_zeros())
    res = _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                     "ecc": g["eccs"], "argp": g["argps"],
                     "M_EB": g["masses"], "R_EB": g["radii"],
                     "fluxratio_EB": g["fluxratios"]}, **const)
    res_twin = _res(lnZt, {"P_orb": 2 * gt["P"], "inc": gt["incs"],
                           "b": gt["b"], "ecc": gt["eccs"],
                           "argp": gt["argps"], "M_EB": gt["masses"],
                           "R_EB": gt["radii"],
                           "fluxratio_EB": gt["fluxratios"]}, **const)
    return res, res_twin


def lnZ_PTP(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, plx,
            contrast_curve_file: str = None, filt: str = "TESS",
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, molusc_file: str = None, key=None,
            importance_sampling: bool = True):
    """PTP: planet around target + bound companion (reference ml.py:386-586)."""
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt)
    qs_in, use_molusc = _molusc(molusc_file, M_s, N)
    d = eng.sample_ptp(_key(key), P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       F32(plx), qs_in, jnp.asarray(seps), jnp.asarray(cons),
                       N=N, flatpriors=flatpriors, use_molusc=use_molusc,
                       cc_filt=cc_filt, stratified=importance_sampling)
    u1a, u2a = _u_arrays(u1, u2, N)
    lnL = lnL_planet(t_ss, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                     d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                     d["g"], d["mask"], exptime=exptime, n_t=n_t, ns=nsamples, chunk=chunk)
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs",
                                  "argps", "fluxratios_comp"))
    return _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                      "R_p": g["rps"], "ecc": g["eccs"], "argp": g["argps"],
                      "fluxratio_comp": g["fluxratios_comp"]},
                M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros())


def lnZ_PEB(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, plx,
            contrast_curve_file: str = None, filt: str = "TESS",
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, molusc_file: str = None, key=None,
            importance_sampling: bool = True):
    """PEB + PEBx2P (reference ml.py:589-866)."""
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt)
    qs_in, use_molusc = _molusc(molusc_file, M_s, N)
    d = eng.sample_peb(_key(key), P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       F32(plx), qs_in, jnp.asarray(seps), jnp.asarray(cons),
                       N=N, use_molusc=use_molusc, cc_filt=cc_filt,
                       stratified=importance_sampling,
                       twin_n=_twin_n(N, importance_sampling))
    t = d["twin"]
    u1a, u2a = _u_arrays(u1, u2, N)
    lnL, lnL_twin = _eb_lnZ_pair(d, t_ss, obs_dev, F32(sigma), u1a, u2a,
                                 exptime, n_t, nsamples, chunk)
    gnames = ("P", "incs", "b", "eccs", "argps", "masses", "radii",
              "fluxratios", "fluxratios_comp")
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"], _gd(d, *gnames))
    lnZt, gt = eng.run_finalize(lnL_twin, t["lnprior"] + t["lnw"],
                                _gd(t, *gnames))
    const = dict(M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                 R_p=_zeros())
    res = _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                     "ecc": g["eccs"], "argp": g["argps"],
                     "M_EB": g["masses"], "R_EB": g["radii"],
                     "fluxratio_EB": g["fluxratios"],
                     "fluxratio_comp": g["fluxratios_comp"]}, **const)
    res_twin = _res(lnZt, {"P_orb": 2 * gt["P"], "inc": gt["incs"],
                           "b": gt["b"], "ecc": gt["eccs"],
                           "argp": gt["argps"], "M_EB": gt["masses"],
                           "R_EB": gt["radii"],
                           "fluxratio_EB": gt["fluxratios"],
                           "fluxratio_comp": gt["fluxratios_comp"]}, **const)
    return res, res_twin


def lnZ_STP(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, plx,
            contrast_curve_file: str = None, filt: str = "TESS",
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, molusc_file: str = None, key=None,
            importance_sampling: bool = True):
    """STP: planet around the unresolved companion (reference ml.py:869-1077)."""
    P_lo, P_hi = _p_bounds(P_orb)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt)
    qs_in, use_molusc = _molusc(molusc_file, M_s, N)
    u1_tab, u2_tab = grid_at_Z(Z, mission, teff_max=10000)
    d = eng.sample_stp(_key(key), P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       F32(plx), qs_in,
                       jnp.asarray(u1_tab.astype(F32)),
                       jnp.asarray(u2_tab.astype(F32)),
                       jnp.asarray(seps), jnp.asarray(cons),
                       N=N, flatpriors=flatpriors, use_molusc=use_molusc,
                       cc_filt=cc_filt, stratified=importance_sampling)
    lnL = lnL_planet(t_ss, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                     d["inc_rad"], d["eccs"], d["w_rad"], d["u1s"], d["u2s"],
                     d["g"], d["mask"], exptime=exptime, n_t=n_t, ns=nsamples, chunk=chunk)
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs", "argps",
                                  "fluxratios_comp", "masses_comp",
                                  "radii_comp", "u1s", "u2s"))
    return _res(lnZ, {"M_s": g["masses_comp"], "R_s": g["radii_comp"],
                      "u1": g["u1s"], "u2": g["u2s"], "P_orb": g["P"],
                      "inc": g["incs"], "b": g["b"], "R_p": g["rps"],
                      "ecc": g["eccs"], "argp": g["argps"],
                      "fluxratio_comp": g["fluxratios_comp"]},
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros())


def lnZ_SEB(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, plx,
            contrast_curve_file: str = None, filt: str = "TESS",
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, molusc_file: str = None, key=None,
            importance_sampling: bool = True):
    """SEB + SEBx2P (reference ml.py:1080-1376; Teff clamp 13000 is bounded
    by the LDC table maximum, ml.py:1181)."""
    P_lo, P_hi = _p_bounds(P_orb)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt)
    qs_in, use_molusc = _molusc(molusc_file, M_s, N)
    u1_tab, u2_tab = grid_at_Z(Z, mission, teff_max=13000)
    d = eng.sample_seb(_key(key), P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       F32(plx), qs_in,
                       jnp.asarray(u1_tab.astype(F32)),
                       jnp.asarray(u2_tab.astype(F32)),
                       jnp.asarray(seps), jnp.asarray(cons),
                       N=N, use_molusc=use_molusc, cc_filt=cc_filt,
                       stratified=importance_sampling,
                       twin_n=_twin_n(N, importance_sampling,
                                      eng.TWIN_DIV_SEB))
    t = d["twin"]
    lnL, lnL_twin = _eb_lnZ_pair(d, t_ss, obs_dev, F32(sigma), d["u1s"],
                                 d["u2s"], exptime, n_t, nsamples, chunk)
    gnames = ("P", "incs", "b", "eccs", "argps", "masses", "radii",
              "fluxratios", "fluxratios_comp", "masses_comp", "radii_comp",
              "u1s", "u2s")
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"], _gd(d, *gnames))
    lnZt, gt = eng.run_finalize(lnL_twin, t["lnprior"] + t["lnw"],
                                _gd(t, *gnames))

    def mk(gg, lz, twin):
        return _res(lz, {"M_s": gg["masses_comp"], "R_s": gg["radii_comp"],
                         "u1": gg["u1s"], "u2": gg["u2s"],
                         "P_orb": 2 * gg["P"] if twin else gg["P"],
                         "inc": gg["incs"], "b": gg["b"],
                         "ecc": gg["eccs"], "argp": gg["argps"],
                         "M_EB": gg["masses"], "R_EB": gg["radii"],
                         "fluxratio_EB": gg["fluxratios"],
                         "fluxratio_comp": gg["fluxratios_comp"]},
                    R_p=_zeros())
    return mk(g, lnZ, False), mk(gt, lnZt, True)


# ---------------------------------------------------------------------------
# Background-star scenarios (TRILEGAL)
# ---------------------------------------------------------------------------

def lnZ_DTP(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, Tmag, Jmag, Hmag,
            Kmag, trilegal_fname, contrast_curve_file: str = None,
            filt: str = "TESS", N: int = 1000000, parallel: bool = False,
            mission: str = "TESS", flatpriors: bool = False,
            exptime: float = 0.00139, nsamples: int = 20, key=None,
            importance_sampling: bool = True):
    """DTP: planet around target diluted by a background star
    (reference ml.py:1379-1568)."""
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt)
    bg, N_comp = _prep_background(trilegal_fname, Tmag, Jmag, Hmag, Kmag,
                                  mission, filt, need_ldc=False)
    d = eng.sample_background_planet(
        _key(key), P_lo, P_hi, F32(M_s), F32(R_s), bg,
        jnp.asarray(seps), jnp.asarray(cons),
        N=N, flatpriors=flatpriors, has_cc=cc_filt is not None,
        host_is_bg=False, stratified=importance_sampling)
    u1a, u2a = _u_arrays(u1, u2, N)
    lnL = lnL_planet(t_ss, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                     d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                     d["g"], d["mask"], exptime=exptime, n_t=n_t, ns=nsamples, chunk=chunk)
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs",
                                  "argps", "fluxratios_comp"))
    return _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                      "R_p": g["rps"], "ecc": g["eccs"], "argp": g["argps"],
                      "fluxratio_comp": g["fluxratios_comp"]},
                M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros())


def lnZ_DEB(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, Tmag, Jmag, Hmag,
            Kmag, trilegal_fname, contrast_curve_file: str = None,
            filt: str = "TESS", N: int = 1000000, parallel: bool = False,
            mission: str = "TESS", flatpriors: bool = False,
            exptime: float = 0.00139, nsamples: int = 20, key=None,
            importance_sampling: bool = True):
    """DEB + DEBx2P (reference ml.py:1571-1837)."""
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt)
    bg, N_comp = _prep_background(trilegal_fname, Tmag, Jmag, Hmag, Kmag,
                                  mission, filt, need_ldc=False)
    d = eng.sample_background_eb(
        _key(key), P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff), bg,
        jnp.asarray(seps), jnp.asarray(cons),
        N=N, has_cc=cc_filt is not None, host_is_bg=False,
        cc_filt=cc_filt or "TESS", stratified=importance_sampling,
        twin_n=_twin_n(N, importance_sampling))
    t = d["twin"]
    u1a, u2a = _u_arrays(u1, u2, N)
    lnL, lnL_twin = _eb_lnZ_pair(d, t_ss, obs_dev, F32(sigma), u1a, u2a,
                                 exptime, n_t, nsamples, chunk)
    gnames = ("P", "incs", "b", "eccs", "argps", "masses", "radii",
              "fluxratios", "fluxratios_comp")
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"], _gd(d, *gnames))
    lnZt, gt = eng.run_finalize(lnL_twin, t["lnprior"] + t["lnw"],
                                _gd(t, *gnames))
    const = dict(M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                 R_p=_zeros())
    res = _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                     "ecc": g["eccs"], "argp": g["argps"],
                     "M_EB": g["masses"], "R_EB": g["radii"],
                     "fluxratio_EB": g["fluxratios"],
                     "fluxratio_comp": g["fluxratios_comp"]}, **const)
    res_twin = _res(lnZt, {"P_orb": 2 * gt["P"], "inc": gt["incs"],
                           "b": gt["b"], "ecc": gt["eccs"],
                           "argp": gt["argps"], "M_EB": gt["masses"],
                           "R_EB": gt["radii"],
                           "fluxratio_EB": gt["fluxratios"],
                           "fluxratio_comp": gt["fluxratios_comp"]}, **const)
    return res, res_twin


def lnZ_BTP(time, flux, sigma, P_orb, M_s, R_s, Teff, Tmag, Jmag, Hmag,
            Kmag, trilegal_fname, contrast_curve_file: str = None,
            filt: str = "TESS", N: int = 1000000, parallel: bool = False,
            mission: str = "TESS", flatpriors: bool = False,
            exptime: float = 0.00139, nsamples: int = 20, key=None,
            importance_sampling: bool = True):
    """BTP: planet around the background star (reference ml.py:1840-2035).
    Per-star LDC from the vectorized two-stage lookup."""
    P_lo, P_hi = _p_bounds(P_orb)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt)
    bg, N_comp = _prep_background(trilegal_fname, Tmag, Jmag, Hmag, Kmag,
                                  mission, filt, need_ldc=True)
    d = eng.sample_background_planet(
        _key(key), P_lo, P_hi, F32(M_s), F32(R_s), bg,
        jnp.asarray(seps), jnp.asarray(cons),
        N=N, flatpriors=flatpriors, has_cc=cc_filt is not None,
        host_is_bg=True, stratified=importance_sampling)
    lnL = lnL_planet(t_ss, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                     d["inc_rad"], d["eccs"], d["w_rad"], d["u1s"], d["u2s"],
                     d["g"], d["mask"], exptime=exptime, n_t=n_t, ns=nsamples, chunk=chunk)
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs", "argps",
                                  "fluxratios_comp", "host_mass", "host_rad",
                                  "u1s", "u2s"))
    return _res(lnZ, {"M_s": g["host_mass"], "R_s": g["host_rad"],
                      "u1": g["u1s"], "u2": g["u2s"], "P_orb": g["P"],
                      "inc": g["incs"], "b": g["b"], "R_p": g["rps"],
                      "ecc": g["eccs"], "argp": g["argps"],
                      "fluxratio_comp": g["fluxratios_comp"]},
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros())


def lnZ_BEB(time, flux, sigma, P_orb, M_s, R_s, Teff, Tmag, Jmag, Hmag,
            Kmag, trilegal_fname, contrast_curve_file: str = None,
            filt: str = "TESS", N: int = 1000000, parallel: bool = False,
            mission: str = "TESS", flatpriors: bool = False,
            exptime: float = 0.00139, nsamples: int = 20, key=None,
            importance_sampling: bool = True):
    """BEB + BEBx2P (reference ml.py:2038-2362)."""
    P_lo, P_hi = _p_bounds(P_orb)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt)
    bg, N_comp = _prep_background(trilegal_fname, Tmag, Jmag, Hmag, Kmag,
                                  mission, filt, need_ldc=True,
                                  need_cc_ratio=True)
    d = eng.sample_background_eb(
        _key(key), P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff), bg,
        jnp.asarray(seps), jnp.asarray(cons),
        N=N, has_cc=cc_filt is not None, host_is_bg=True,
        cc_filt=cc_filt or "TESS", stratified=importance_sampling,
        twin_n=_twin_n(N, importance_sampling))
    t = d["twin"]
    lnL, lnL_twin = _eb_lnZ_pair(d, t_ss, obs_dev, F32(sigma), d["u1s"],
                                 d["u2s"], exptime, n_t, nsamples, chunk)
    gnames = ("P", "incs", "b", "eccs", "argps", "masses", "radii",
              "fluxratios", "fluxratios_comp", "host_mass", "host_rad",
              "u1s", "u2s")
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"], _gd(d, *gnames))
    lnZt, gt = eng.run_finalize(lnL_twin, t["lnprior"] + t["lnw"],
                                _gd(t, *gnames))

    def mk(gg, lz, twin):
        return _res(lz, {"M_s": gg["host_mass"], "R_s": gg["host_rad"],
                         "u1": gg["u1s"], "u2": gg["u2s"],
                         "P_orb": 2 * gg["P"] if twin else gg["P"],
                         "inc": gg["incs"], "b": gg["b"],
                         "ecc": gg["eccs"], "argp": gg["argps"],
                         "M_EB": gg["masses"], "R_EB": gg["radii"],
                         "fluxratio_EB": gg["fluxratios"],
                         "fluxratio_comp": gg["fluxratios_comp"]},
                    R_p=_zeros())
    return mk(g, lnZ, False), mk(gt, lnZt, True)


# ---------------------------------------------------------------------------
# Nearby-star scenarios for stars of unknown / evolved properties
# ---------------------------------------------------------------------------

_EMPTY_NTP = {"M_s": 0, "R_s": 0, "u1": 0, "u2": 0, "P_orb": 0, "inc": 0,
              "R_p": 0, "ecc": 0, "argp": 0, "M_EB": 0, "R_EB": 0,
              "fluxratio_EB": 0, "fluxratio_comp": 0, "lnZ": -np.inf}
_EMPTY_NEB = {"M_s": 0, "R_s": 0, "u1": 0, "u2": 0, "P_orb": 0, "inc": 0,
              "b": 0, "R_p": 0, "ecc": 0, "argp": 0, "M_EB": 0, "R_EB": 0,
              "fluxratio_EB": 0, "fluxratio_comp": 0, "lnZ": -np.inf}


def lnZ_NTP_unknown(time, flux, sigma, P_orb, Tmag, trilegal_fname,
                    N: int = 1000000, parallel: bool = False,
                    mission: str = "TESS", flatpriors: bool = False,
                    exptime: float = 0.00139, nsamples: int = 20, key=None,
            importance_sampling: bool = True):
    """NTP for a star of unknown properties drawn from the TRILEGAL
    Tmag +/- 1 lookalike population (reference ml.py:2365-2551). Empty
    population -> lnZ = -inf early return (the reference's empty-res dict
    omits the 'b' key; preserved)."""
    pop, N_pos = _prep_lookalikes(trilegal_fname, Tmag, mission)
    if N_pos == 0:
        return dict(_EMPTY_NTP)
    P_lo, P_hi = _p_bounds(P_orb)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    d = eng.sample_ntp_unknown(_key(key), P_lo, P_hi, pop,
                               N=N, flatpriors=flatpriors,
                               stratified=importance_sampling)
    lnL = lnL_planet(t_ss, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                     d["inc_rad"], d["eccs"], d["w_rad"], d["u1s"], d["u2s"],
                     d["g"], d["mask"], exptime=exptime, n_t=n_t, ns=nsamples, chunk=chunk)
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs", "argps",
                                  "host_mass", "host_rad", "u1s", "u2s"))
    return _res(lnZ, {"M_s": g["host_mass"], "R_s": g["host_rad"],
                      "u1": g["u1s"], "u2": g["u2s"], "P_orb": g["P"],
                      "inc": g["incs"], "b": g["b"], "R_p": g["rps"],
                      "ecc": g["eccs"], "argp": g["argps"]},
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros(),
                fluxratio_comp=_zeros())


def lnZ_NEB_unknown(time, flux, sigma, P_orb, Tmag, trilegal_fname,
                    N: int = 1000000, parallel: bool = False,
                    mission: str = "TESS", flatpriors: bool = False,
                    exptime: float = 0.00139, nsamples: int = 20, key=None,
            importance_sampling: bool = True):
    """NEB for a star of unknown properties (reference ml.py:2554-2829)."""
    pop, N_pos = _prep_lookalikes(trilegal_fname, Tmag, mission)
    if N_pos == 0:
        return dict(_EMPTY_NEB)
    P_lo, P_hi = _p_bounds(P_orb)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    d = eng.sample_neb_unknown(_key(key), P_lo, P_hi, pop, N=N,
                               stratified=importance_sampling,
                               twin_n=_twin_n(N, importance_sampling))
    t = d["twin"]
    lnL, lnL_twin = _eb_lnZ_pair(d, t_ss, obs_dev, F32(sigma), d["u1s"],
                                 d["u2s"], exptime, n_t, nsamples, chunk)
    gnames = ("P", "incs", "b", "eccs", "argps", "masses", "radii",
              "fluxratios", "host_mass", "host_rad", "u1s", "u2s")
    lnZ, g = eng.run_finalize(lnL, d["lnw"], _gd(d, *gnames))
    lnZt, gt = eng.run_finalize(lnL_twin, t["lnw"], _gd(t, *gnames))

    def mk(gg, lz, twin):
        return _res(lz, {"M_s": gg["host_mass"], "R_s": gg["host_rad"],
                         "u1": gg["u1s"], "u2": gg["u2s"],
                         "P_orb": 2 * gg["P"] if twin else gg["P"],
                         "inc": gg["incs"], "b": gg["b"],
                         "ecc": gg["eccs"], "argp": gg["argps"],
                         "M_EB": gg["masses"], "R_EB": gg["radii"],
                         "fluxratio_EB": gg["fluxratios"]},
                    R_p=_zeros(), fluxratio_comp=_zeros())
    return mk(g, lnZ, False), mk(gt, lnZt, True)


def lnZ_NTP_evolved(time, flux, sigma, P_orb, R_s, Teff, Z,
                    N: int = 1000000, parallel: bool = False,
                    mission: str = "TESS", flatpriors: bool = False,
                    exptime: float = 0.00139, nsamples: int = 20, key=None,
            importance_sampling: bool = True):
    """NTP for subgiants: logg = 3.0 assumption sets the host mass
    (reference ml.py:2832-2966)."""
    M_s = (10**3.0) * (R_s * RSUN) ** 2 / G / MSUN
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, 3.0, mission)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    d = eng.sample_planet_target(_key(key), P_lo, P_hi, F32(M_s), F32(R_s),
                                 N=N, flatpriors=flatpriors,
                               stratified=importance_sampling)
    u1a, u2a = _u_arrays(u1, u2, N)
    lnL = lnL_planet(t_ss, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                     d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                     jnp.ones((N,), jnp.float32), d["mask"],
                     exptime=exptime, n_t=n_t, ns=nsamples, chunk=chunk)
    lnZ, g = eng.run_finalize(lnL, d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs", "argps"))
    return _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                      "R_p": g["rps"], "ecc": g["eccs"], "argp": g["argps"]},
                M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros(),
                fluxratio_comp=_zeros())


def lnZ_NEB_evolved(time, flux, sigma, P_orb, R_s, Teff, Z,
                    N: int = 1000000, parallel: bool = False,
                    mission: str = "TESS", flatpriors: bool = False,
                    exptime: float = 0.00139, nsamples: int = 20, key=None,
            importance_sampling: bool = True):
    """NEB for subgiants + twin (reference ml.py:2969-3178, quirks
    documented in the sampler)."""
    M_s = (10**3.0) * (R_s * RSUN) ** 2 / G / MSUN
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, 3.0, mission)
    t_ss, obs_dev, n_t, chunk = _lc(time, flux, exptime, nsamples)
    d = eng.sample_neb_evolved(_key(key), P_lo, P_hi, F32(M_s), F32(R_s),
                               F32(Teff), N=N,
                               stratified=importance_sampling,
                               twin_n=_twin_n(N, importance_sampling))
    t = d["twin"]
    u1a, u2a = _u_arrays(u1, u2, N)
    lnL, lnL_twin = _eb_lnZ_pair(d, t_ss, obs_dev, F32(sigma), u1a, u2a,
                                 exptime, n_t, nsamples, chunk)
    gnames = ("P", "incs", "b", "eccs", "argps", "masses", "radii",
              "fluxratios")
    lnZ, g = eng.run_finalize(lnL, d["lnw"], _gd(d, *gnames))
    lnZt, gt = eng.run_finalize(lnL_twin, t["lnw"], _gd(t, *gnames))
    const = dict(M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                 R_p=_zeros(), fluxratio_comp=_zeros())
    res = _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                     "ecc": g["eccs"], "argp": g["argps"],
                     "M_EB": g["masses"], "R_EB": g["radii"],
                     "fluxratio_EB": g["fluxratios"]}, **const)
    res_twin = _res(lnZt, {"P_orb": 2 * gt["P"], "inc": gt["incs"],
                           "b": gt["b"], "ecc": gt["eccs"],
                           "argp": gt["argps"], "M_EB": gt["masses"],
                           "R_EB": np.full(N_SAMPLES, R_s),
                           "fluxratio_EB": gt["fluxratios"]}, **const)
    return res, res_twin
