"""Scenario Monte-Carlo marginalization engine (device-side).

Shared machinery behind the 14 public ``lnZ_*`` scenario functions
(scenarios/api.py). Per scenario the flow is three jitted dispatches that
keep all N-draw arrays on device:

  1. a per-scenario sampler (this module): threefry-keyed uniform draws ->
     inverse-CDF priors -> Kepler-III geometry -> transit-probability /
     collision / population masks (static shapes; where-masking instead of
     the reference's boolean compaction, SURVEY.md section 7 "hard parts"),
  2. the chunked likelihood core (ops/lightcurve.py),
  3. ``finalize``: masked log-mean-exp evidence + top-100 best-fit gather
     (reference marginal_likelihoods.py:152-172).

Geometric importance sampling (``stratified=True``, the default): the
reference samples cos(inc) ~ U[0,1] and rejects the ~(1 - Ptra) fraction
of draws that never transit (ml.py:120-123), wasting most of the compute.
Here cos(inc) is drawn from U[0, min(Ptra, 1)] and the draw re-weighted
by ln w = ln min(Ptra, 1), an exact reweighting of the same marginal
integral: every surviving lane carries signal, reducing both wasted FLOPs
and Monte-Carlo variance by ~1/E[Ptra] (typically 10-30x). Draws with
Ptra > 1 keep the reference's exclusion quirk (zero weight). With
``stratified=False`` the reference's plain rejection scheme is used
bit-for-bit in structure; both modes agree within MC noise
(tests/test_scenarios.py).

The reference's per-draw quantities and masks are otherwise reproduced
exactly (file:line citations at each step); RNG is keyed (not a global
stream) so only distributional equivalence holds (SURVEY.md section 7).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import G, MSUN, RSUN, REARTH, PI
from ..core.numerics import log_mean_exp_jax
from ..priors.samplers import (
    sample_rp, sample_inc, sample_ecc, sample_w, sample_q, sample_q_companion,
    q_below_twin_cdf,
)
from ..priors.companion import (
    lnprior_bound_TP, lnprior_bound_EB, lnprior_background,
    clamp_companion_prior,
)
from ..populations.stellar import stellar_relations, flux_relation
from ..populations.ldc import round_index_comp
from ..ops.lightcurve import (
    eb_radius_ratios, tp_dilution, eb_dilution,
)

F32 = jnp.float32
N_SAMPLES = 100  # top-k best-fit draws kept (reference ml.py:152)
TWIN_DIV = 4      # twin-branch conditioned draw count = N // TWIN_DIV
TWIN_DIV_SEB = 2  # SEB only: its twin needle is bimodal (grazing OR
                  # heavy companion dilution) and carries ~3x the lnZ
                  # variance of the other twins at matched draws
                  # (docs/parity.md), so it gets 2x the twin draws


# ---------------------------------------------------------------------------
# Shared draw/geometry helpers (jnp, called inside jitted samplers)
# ---------------------------------------------------------------------------

def _uniforms(key, n_streams, N):
    keys = jax.random.split(key, n_streams)
    return [jax.random.uniform(k, (N,), dtype=F32) for k in keys]


def _draw_P(u, P_lo, P_hi):
    return P_lo + u * (P_hi - P_lo)


def _semimajor(P_days, M_tot_msun):
    """Kepler III semimajor axis [cm] (reference ml.py:75)."""
    return ((G * M_tot_msun * MSUN) / (4 * PI**2) * (P_days * 86400.0) ** 2) ** (1.0 / 3.0)


def _geom_base(P, M_tot, R_host_rsun, R_occ_cm, eccs, argps_deg):
    """a [cm], Ptra, coll, r [cm] (reference ml.py:107-115)."""
    a = _semimajor(P, M_tot)
    sin_argp = jnp.sin(argps_deg * PI / 180.0)
    e_corr = (1.0 + eccs * sin_argp) / (1.0 - eccs**2)
    R_host_cm = R_host_rsun * RSUN
    Ptra = (R_occ_cm + R_host_cm) / a * e_corr
    r = a * (1.0 - eccs**2) / (1.0 + eccs * sin_argp)
    coll = (R_occ_cm + R_host_cm) > a * (1.0 - eccs)
    return a, Ptra, coll, r


def _inc_weighted(u_inc, Ptra, stratified: bool):
    """Inclination draw + geometric transit handling.

    stratified: cos(inc) ~ U[0, min(Ptra,1)], ln-weight = ln min(Ptra,1);
    plain: cos(inc) ~ U[0,1] with the reference's rejection mask
    (inc >= arccos(Ptra), Ptra <= 1; ml.py:120-123). Returns
    (incs_deg, tra_ok, lnw)."""
    if stratified:
        w = jnp.minimum(Ptra, 1.0)
        cosi = u_inc * w
        incs_deg = jnp.arccos(cosi) * (180.0 / PI)
        tra_ok = Ptra <= 1.0
        lnw = jnp.log(w)
        return incs_deg, tra_ok, lnw
    incs_deg = sample_inc(u_inc)
    cosi = jnp.cos(incs_deg * PI / 180.0)
    tra_ok = (Ptra <= 1.0) & (cosi <= Ptra)
    return incs_deg, tra_ok, jnp.zeros_like(Ptra)


def _impact_param(r_cm, incs_deg, R_host_rsun):
    return r_cm * jnp.cos(incs_deg * PI / 180.0) / (R_host_rsun * RSUN)


def _kernel_angles(incs_deg, argps_deg):
    """(inc_rad, w_rad) with the reference's w = (90 - argp) deg convention
    (reference likelihoods.py:70, :345)."""
    return incs_deg * (PI / 180.0), (90.0 - argps_deg) * (PI / 180.0)


def _fluxratio_vs_target(masses, M_s, filt="TESS"):
    """F_star / (F_star + F_target) in the given band (ref ml.py:248-251)."""
    f = flux_relation(masses, filt, xp=jnp)
    ft = flux_relation(jnp.asarray([M_s], dtype=masses.dtype), filt, xp=jnp)
    return f / (f + ft)


def _companion_prior_bound(kind, M_s, plx, masses_comp, fluxratios_comp,
                           cc_filt, seps, cons):
    """Shared bound-companion prior block for P*/S* scenarios
    (reference ml.py:478-509, :695-727, :974-1002, :1198-1237).

    kind: 'TP' or 'EB'. When cc_filt is None the TESS-band flux ratios
    define delta_mag and (seps, cons) = ([2.2], [1.0]); otherwise the
    contrast-curve filter band is used."""
    if cc_filt is None:
        fr = fluxratios_comp
    else:
        fr = _fluxratio_vs_target(masses_comp, M_s, cc_filt)
    delta_mags = 2.5 * jnp.log10(fr / (1.0 - fr))
    fn = lnprior_bound_TP if kind == "TP" else lnprior_bound_EB
    lnp = fn(M_s, plx, jnp.abs(delta_mags), seps, cons)
    return clamp_companion_prior(lnp, delta_mags)


def _background_prior(has_cc, N_comp, fluxratios_draw, delta_band_draw,
                      seps, cons, extra_fluxratio=None):
    """Background-star prior block for D*/B* scenarios
    (reference ml.py:1466-1492, :1929-1955, :2184-2209). N_comp may be a
    python int or a traced per-target count (sharded batch path)."""
    if not has_cc:
        fr_tot = fluxratios_draw / (1.0 - fluxratios_draw)
        if extra_fluxratio is not None:
            fr_tot = fr_tot + extra_fluxratio / (1.0 - extra_fluxratio)
        delta_mags = 2.5 * jnp.log10(fr_tot)
        lnp = (jnp.zeros_like(delta_mags)
               + jnp.log((N_comp / 0.1) * (1.0 / 3600.0) ** 2 * 2.2**2))
    else:
        delta_mags = delta_band_draw
        lnp = lnprior_background(N_comp, jnp.abs(delta_mags), seps, cons)
    return clamp_companion_prior(lnp, delta_mags)


# field order of the packed background/lookalike tables (one (N_rows, F)
# f32 matrix, gathered once per draw batch: one packed row gather in
# place of 9 per-field gathers)
BG_PACK_FIELDS = ("fluxratios", "delta_band", "masses", "radii", "loggs",
                  "teffs", "u1s", "u2s", "fluxratios_cc")
POP_PACK_FIELDS = ("masses", "radii", "loggs", "teffs", "u1s", "u2s")


def _drawn_rows(tab, idxs, fields):
    """Per-draw star properties: one packed gather when 'pack' is
    present (built by the host preps), per-field gathers otherwise."""
    if "pack" in tab:
        rows = tab["pack"][idxs]
        return {f: rows[:, i] for i, f in enumerate(fields)}
    return {f: tab[f][idxs] for f in fields if f in tab}


# ---------------------------------------------------------------------------
# Finalize: evidence + top-k best fits
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("N",))
def finalize(lnL, lnprior, gather_arrays, *, N: int):
    """lnZ = log_mean_exp(lnL + lnprior) over all N draws; top-100 draws
    ranked by lnL alone (reference ml.py:152-154)."""
    lnZ = log_mean_exp_jax(lnL + lnprior, N)
    k = min(N_SAMPLES, N)
    _, idx = jax.lax.top_k(lnL, k)
    gathered = tuple(jnp.take(a, idx) for a in gather_arrays)
    return lnZ, gathered


def run_finalize(lnL, lnprior, gather: dict):
    """Dispatch finalize; returns device values (no host sync), so the
    next scenario's work can be enqueued while this one computes.
    Callers convert with float()/np.asarray() when needed."""
    names = list(gather.keys())
    lnZ, vals = finalize(lnL, lnprior, tuple(gather[n] for n in names),
                         N=lnL.shape[0])
    return lnZ, dict(zip(names, vals))


# ---------------------------------------------------------------------------
# Planet-family samplers
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("N", "flatpriors", "stratified"))
def sample_planet_target(key, P_lo, P_hi, M_s, R_s, *, N, flatpriors,
                         stratified=True):
    """Draws for TTP / NTP / NTP_evolved-style scenarios: planet around a
    star with fixed properties (reference ml.py:100-123)."""
    u = _uniforms(key, 5, N)
    P = _draw_P(u[0], P_lo, P_hi)
    rps = sample_rp(u[1], jnp.full((N,), M_s, F32), flatpriors)
    eccs = sample_ecc(u[3], True, jnp.mean(P))
    argps = sample_w(u[4])
    a, Ptra, coll, r = _geom_base(P, M_s, R_s, rps * REARTH, eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[2], Ptra, stratified)
    b = _impact_param(r, incs, R_s)
    mask = tra_ok & ~coll
    inc_rad, w_rad = _kernel_angles(incs, argps)
    return dict(P=P, rps=rps, incs=incs, eccs=eccs, argps=argps, a=a, b=b,
                mask=mask, lnw=lnw, inc_rad=inc_rad, w_rad=w_rad,
                k=rps * REARTH / (R_s * RSUN), a_R=a / (R_s * RSUN))


@partial(jax.jit, static_argnames=("N", "flatpriors", "use_molusc", "cc_filt",
                                   "stratified"))
def sample_ptp(key, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps, cons,
               *, N, flatpriors, use_molusc, cc_filt, stratified=True):
    """PTP: planet around target + unresolved bound companion
    (reference ml.py:386-586)."""
    u = _uniforms(key, 6, N)
    if use_molusc:
        qs_comp = qs_comp_in
    else:
        qs_comp = sample_q_companion(u[5], M_s)
    masses_comp = qs_comp * M_s
    fluxratios_comp = _fluxratio_vs_target(masses_comp, M_s)
    if use_molusc:
        lnprior = jnp.zeros((N,), F32)
    else:
        lnprior = _companion_prior_bound(
            "TP", M_s, plx, masses_comp, fluxratios_comp, cc_filt, seps, cons)
    P = _draw_P(u[0], P_lo, P_hi)
    rps = sample_rp(u[1], jnp.full((N,), M_s, F32), flatpriors)
    eccs = sample_ecc(u[3], True, jnp.mean(P))
    argps = sample_w(u[4])
    a, Ptra, coll, r = _geom_base(P, M_s, R_s, rps * REARTH, eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[2], Ptra, stratified)
    b = _impact_param(r, incs, R_s)
    mask = tra_ok & ~coll & (qs_comp != 0.0)
    inc_rad, w_rad = _kernel_angles(incs, argps)
    F_comp = fluxratios_comp / (1.0 - fluxratios_comp)
    g = tp_dilution(F_comp, companion_is_host=False)
    return dict(P=P, rps=rps, incs=incs, eccs=eccs, argps=argps, a=a, b=b,
                mask=mask, lnw=lnw, inc_rad=inc_rad, w_rad=w_rad,
                k=rps * REARTH / (R_s * RSUN), a_R=a / (R_s * RSUN),
                g=g, lnprior=lnprior, fluxratios_comp=fluxratios_comp)


@partial(jax.jit, static_argnames=("N", "flatpriors", "use_molusc", "cc_filt",
                                   "stratified"))
def sample_stp(key, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in,
               u1_tab, u2_tab, seps, cons, *, N, flatpriors, use_molusc,
               cc_filt, stratified=True):
    """STP: planet around the unresolved bound companion; per-draw LDC via
    clamped rounding on the nearest-Z grid slice (reference ml.py:869-1077,
    LDC rounding :961-972)."""
    u = _uniforms(key, 6, N)
    if use_molusc:
        qs_comp = qs_comp_in
    else:
        qs_comp = sample_q_companion(u[5], M_s)
    masses_comp = qs_comp * M_s
    radii_comp, teffs_comp = stellar_relations(
        masses_comp, jnp.full((N,), R_s, F32), jnp.full((N,), Teff, F32), xp=jnp)
    loggs_comp = jnp.log10(G * (masses_comp * MSUN) /
                           jnp.maximum(radii_comp * RSUN, 1.0) ** 2)
    fluxratios_comp = _fluxratio_vs_target(masses_comp, M_s)
    i_logg, i_teff = round_index_comp(loggs_comp, teffs_comp,
                                      u1_tab.shape[1], xp=jnp)
    u1s = u1_tab[i_logg, i_teff]
    u2s = u2_tab[i_logg, i_teff]
    if use_molusc:
        lnprior = jnp.zeros((N,), F32)
    else:
        lnprior = _companion_prior_bound(
            "TP", M_s, plx, masses_comp, fluxratios_comp, cc_filt, seps, cons)
    P = _draw_P(u[0], P_lo, P_hi)
    rps = sample_rp(u[1], masses_comp, flatpriors)
    eccs = sample_ecc(u[3], True, jnp.mean(P))
    argps = sample_w(u[4])
    a, Ptra, coll, r = _geom_base(P, masses_comp, radii_comp, rps * REARTH,
                                  eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[2], Ptra, stratified)
    b = _impact_param(r, incs, radii_comp)
    mask = tra_ok & ~coll & (qs_comp != 0.0)
    inc_rad, w_rad = _kernel_angles(incs, argps)
    F_comp = fluxratios_comp / (1.0 - fluxratios_comp)
    g = tp_dilution(F_comp, companion_is_host=True)
    return dict(P=P, rps=rps, incs=incs, eccs=eccs, argps=argps, a=a, b=b,
                mask=mask, lnw=lnw, inc_rad=inc_rad, w_rad=w_rad,
                k=rps * REARTH / (radii_comp * RSUN),
                a_R=a / (radii_comp * RSUN), g=g, lnprior=lnprior,
                fluxratios_comp=fluxratios_comp, masses_comp=masses_comp,
                radii_comp=radii_comp, u1s=u1s, u2s=u2s)


@partial(jax.jit, static_argnames=("N", "flatpriors", "has_cc", "host_is_bg",
                                   "stratified"))
def sample_background_planet(key, P_lo, P_hi, M_s, R_s, bg, seps, cons,
                             *, N, flatpriors, has_cc, host_is_bg,
                             stratified=True, n_comp=None):
    """DTP (host_is_bg=False) and BTP (host_is_bg=True): planet around the
    target diluted by a TRILEGAL background star, or around the background
    star itself (reference ml.py:1379-1568 DTP, :1840-2035 BTP).

    The draw-index quirk is preserved: DTP uses randint high = N_comp - 1
    (exclusive -> last star never drawn, ml.py:1463), BTP uses
    high = N_comp (ml.py:1926).

    n_comp: optional traced per-target population count (< the padded
    table length) for the sharded batch path; defaults to the static
    table length."""
    u = _uniforms(key, 5, N)
    key_idx = jax.random.fold_in(key, 777)
    N_comp = bg["fluxratios"].shape[0] if n_comp is None else n_comp
    hi = N_comp if host_is_bg else jnp.maximum(N_comp - 1, 1)
    idxs = jax.random.randint(key_idx, (N,), 0, hi)
    row = _drawn_rows(bg, idxs, BG_PACK_FIELDS)
    fluxratios_draw = row["fluxratios"]
    delta_band_draw = row["delta_band"]
    lnprior = _background_prior(has_cc, N_comp, fluxratios_draw,
                                delta_band_draw, seps, cons)
    P = _draw_P(u[0], P_lo, P_hi)
    if host_is_bg:
        host_mass = row["masses"]
        host_rad = row["radii"]
        u1s, u2s = row["u1s"], row["u2s"]
        pop_ok = (row["loggs"] >= 3.5) & (row["teffs"] <= 10000.0)
        g = tp_dilution(fluxratios_draw / (1.0 - fluxratios_draw), True)
    else:
        host_mass = jnp.full((N,), M_s, F32)
        host_rad = jnp.full((N,), R_s, F32)
        u1s = u2s = None
        pop_ok = jnp.ones((N,), bool)
        g = tp_dilution(fluxratios_draw / (1.0 - fluxratios_draw), False)
    rps = sample_rp(u[1], host_mass, flatpriors)
    eccs = sample_ecc(u[3], True, jnp.mean(P))
    argps = sample_w(u[4])
    a, Ptra, coll, r = _geom_base(P, host_mass, host_rad, rps * REARTH,
                                  eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[2], Ptra, stratified)
    b = _impact_param(r, incs, host_rad)
    mask = tra_ok & ~coll & pop_ok
    inc_rad, w_rad = _kernel_angles(incs, argps)
    out = dict(P=P, rps=rps, incs=incs, eccs=eccs, argps=argps, a=a, b=b,
               mask=mask, lnw=lnw, inc_rad=inc_rad, w_rad=w_rad,
               k=rps * REARTH / (host_rad * RSUN),
               a_R=a / (host_rad * RSUN), g=g, lnprior=lnprior,
               fluxratios_comp=fluxratios_draw, idxs=idxs,
               host_mass=host_mass, host_rad=host_rad)
    if u1s is not None:
        out["u1s"], out["u2s"] = u1s, u2s
    return out


@partial(jax.jit, static_argnames=("N", "flatpriors", "stratified"))
def sample_ntp_unknown(key, P_lo, P_hi, pop, *, N, flatpriors,
                       stratified=True):
    """NTP for a star of unknown properties: host drawn from the TRILEGAL
    Tmag +/- 1 lookalike population, no dilution
    (reference ml.py:2365-2551)."""
    u = _uniforms(key, 5, N)
    key_idx = jax.random.fold_in(key, 777)
    N_pos = pop["masses"].shape[0]
    idxs = jax.random.randint(key_idx, (N,), 0, N_pos)
    row = _drawn_rows(pop, idxs, POP_PACK_FIELDS)
    host_mass = row["masses"]
    host_rad = row["radii"]
    u1s, u2s = row["u1s"], row["u2s"]
    pop_ok = (row["loggs"] >= 3.5) & (row["teffs"] <= 10000.0)
    P = _draw_P(u[0], P_lo, P_hi)
    rps = sample_rp(u[1], host_mass, flatpriors)
    eccs = sample_ecc(u[3], True, jnp.mean(P))
    argps = sample_w(u[4])
    a, Ptra, coll, r = _geom_base(P, host_mass, host_rad, rps * REARTH,
                                  eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[2], Ptra, stratified)
    b = _impact_param(r, incs, host_rad)
    mask = tra_ok & ~coll & pop_ok
    inc_rad, w_rad = _kernel_angles(incs, argps)
    return dict(P=P, rps=rps, incs=incs, eccs=eccs, argps=argps, a=a, b=b,
                mask=mask, lnw=lnw, inc_rad=inc_rad, w_rad=w_rad,
                k=rps * REARTH / (host_rad * RSUN),
                a_R=a / (host_rad * RSUN), idxs=idxs,
                host_mass=host_mass, host_rad=host_rad, u1s=u1s, u2s=u2s,
                g=jnp.ones((N,), F32), lnprior=jnp.zeros((N,), F32))


# --------------------------- EB-family samplers ----------------------------
#
# Twin (EBx2P) stratification: with ``stratified=True`` and ``twin_n > 0``
# every EB sampler returns a ``d["twin"]`` dict holding an INDEPENDENT
# conditioned draw set of size twin_n instead of sharing the normal
# branch's N draws:
#
#   * q is drawn from q | q >= 0.95 via the analytic CDF
#     (priors.samplers.q_below_twin_cdf), carrying exact ln-weight
#     log P(q >= 0.95) — every twin lane is in-band instead of ~27%.
#   * cos(inc) is drawn from a grazing-edge mixture over [0, min(Ptra,1)]:
#     the twin model's undiluted depth is enormous, so the evidence is
#     dominated by a thin grazing sliver at the top of the cos(inc)
#     range; the mixture places half the draws in the top _TWIN_EDGE
#     fraction with exact density reweighting.
#   * the (inc, q, w, ecc[, q_comp]) uniforms are Latin-hypercube
#     stratified (_lattice_strat): per-axis sliver hit counts become
#     deterministic while every lane's joint draw stays exactly uniform.
#
# All three are exact importance reweightings of the reference's
# estimator (marginal_likelihoods.py twin branches, e.g. ml.py:253-268):
# the twin lnZ uses N_total = twin_n with the weights absorbing
# P(q >= 0.95) and the proposal densities. With ``twin_n = N // 4``
# (N // 2 for SEB, whose twin needle is bimodal — grazing OR heavy
# companion dilution — and noisier) the twin core costs ~4x less while
# its effective in-band sample size slightly exceeds the shared-draw
# scheme's, and the grazing mixture cuts the max-domination variance
# further (docs/parity.md twin-stratification table).
#
# With ``twin_n = 0`` (or stratified=False) the legacy shared-draw twin
# branch is kept bit-for-bit and ``d["twin"]`` is an aliased view of it,
# so all consumers read the twin branch uniformly through ``d["twin"]``.

# Grazing-edge mixture components (mass, edge-width fraction of the
# cos(inc) range). The widest component is the full range; the narrow
# one concentrates draws where the twin model's enormous undiluted
# eclipse grazes down to the observed shallow depth (a sliver near
# b -> 1+k, i.e. the top of the cos(inc) range). A third level at the
# top 0.5% was measured and REJECTED: it starved the mid-edge and
# roughly tripled every twin's key-to-key lnZ sd (docs/parity.md).
_TWIN_EDGE = ((0.5, 1.0), (0.5, 0.05), (0.0, 0.005))


def _lattice_strat(u, axes, n, key):
    """Latin-hypercube stratification of selected uniform streams:
    stream ``axes[j]`` becomes (pi_j(i) + u_i) / n with a uniform
    random permutation pi_j per axis (independent across axes, keyed
    off ``key``; identity on the first axis, see cost note) and the
    original iid uniform as within-cell jitter.

    Conditionally on a lane's cell in the first axis, its remaining
    coordinates are exactly joint-uniform (each pi_j(i) is marginally
    uniform and independent across axes), so the estimator is the
    classic stratified-sampling average — exactly unbiased with honest
    key-to-key variance — while every 1/n-cell of every stratified
    axis is hit exactly once: per-axis sliver hit counts are
    deterministic instead of Binomial, which is the variance term that
    dominated the twin-branch and bound-companion evidences (thin
    slivers of (cos inc, q, w, ecc, q_comp) space).

    Two rejected alternatives, measured (docs/parity.md): a jittered
    Korobov lattice WITHOUT a shared shift is biased (each lane
    integrates only its own cell; the fixed measure-n^(1-d) union of
    cells missed the SEB needle entirely — evidence 3.8 nats low with
    zero key-to-key variance), and a Cranley-Patterson-shifted lattice
    is unbiased but INCREASES variance on needle integrands (all lanes
    hit or miss the needle together).

    Cost control (the sorts are a visible share of the 15-scenario
    bench): the FIRST stratified axis keeps the identity assignment —
    classic stratified sampling needs no permutation on one axis; the
    estimator stays exactly unbiased because the other axes' draws are
    (conditionally on the lane) uniform — and the remaining axes'
    permutations come from ONE batched argsort of iid uniforms instead
    of per-axis sequential sorts."""
    out = list(u)
    dt = out[axes[0]].dtype
    base = jnp.arange(n, dtype=dt)
    out[axes[0]] = (base + out[axes[0]]) / n
    rest = axes[1:]
    if rest:
        r = jax.random.uniform(jax.random.fold_in(key, 7100),
                               (len(rest), n))
        perms = jnp.argsort(r, axis=1)
        for j, ax in enumerate(rest):
            out[ax] = (perms[j].astype(dt) + out[ax]) / n
    return out


def _inc_twin_mixture(u_inc, Ptra):
    """cos(inc) from the 3-level grazing-edge mixture over
    [0, w = min(Ptra, 1)].

    Proposal density q(c) = sum_k a_k/(d_k w) 1{c > w(1-d_k)} over the
    _TWIN_EDGE components, sampled by the exact piecewise-linear
    inverse CDF (monotone in u, preserving the LHS stratification) with
    ln-weight -ln q(c) (target density 1 on cos inc in [0,1], as in the
    reference's rejection scheme)."""
    (a1, _), (a2, d1), (a3, d2) = _TWIN_EDGE
    w = jnp.minimum(Ptra, 1.0)
    t1, t2 = 1.0 - d1, 1.0 - d2
    dens1 = a1
    dens2 = a1 + a2 / d1
    dens3 = a1 + a2 / d1 + a3 / d2
    m1 = dens1 * t1
    m2 = m1 + dens2 * (t2 - t1)
    t = jnp.where(
        u_inc < m1, u_inc / dens1,
        jnp.where(u_inc < m2, t1 + (u_inc - m1) / dens2,
                  t2 + (u_inc - m2) / dens3))
    dens = jnp.where(u_inc < m1, dens1,
                     jnp.where(u_inc < m2, dens2, dens3)) / w
    cosi = w * t
    incs_deg = jnp.arccos(jnp.clip(cosi, 0.0, 1.0)) * (180.0 / PI)
    tra_ok = Ptra <= 1.0
    return incs_deg, tra_ok, -jnp.log(dens)


def _twin_q(u, M_q):
    """(qs, ln-mass): q | q >= 0.95 by inverse-CDF restriction."""
    u095 = q_below_twin_cdf(M_q)
    qs = sample_q(u095 + u * (1.0 - u095), M_q)
    return qs, jnp.log1p(-u095)


def _twin_geom(P, M_tot, R_host_rsun, radii_rsun, eccs, argps_deg, u_inc,
               coll_R_occ_cm, Ptra_R_occ_cm=None):
    """Twin-branch geometry at 2P on a conditioned draw set with the
    grazing-edge inclination mixture. Ptra_R_occ_cm overrides the
    transit-probability radius for the NEB_evolved 2*R_s quirk
    (reference ml.py:3052)."""
    a_twin = _semimajor(2.0 * P, M_tot)
    sin_argp = jnp.sin(argps_deg * PI / 180.0)
    e_corr = (1.0 + eccs * sin_argp) / (1.0 - eccs**2)
    R_occ = (radii_rsun * RSUN + R_host_rsun * RSUN
             if Ptra_R_occ_cm is None else Ptra_R_occ_cm)
    Ptra = R_occ / a_twin * e_corr
    r_twin = a_twin * (1.0 - eccs**2) / (1.0 + eccs * sin_argp)
    coll = coll_R_occ_cm > a_twin * (1.0 - eccs)
    incs, tra_ok, lnw = _inc_twin_mixture(u_inc, Ptra)
    b = _impact_param(r_twin, incs, R_host_rsun)
    return dict(a=a_twin, incs=incs, b=b, geo_ok=tra_ok & ~coll, lnw=lnw)


def _twin_pack(P, qs, eccs, argps, masses, radii, fluxratios, tb,
               R_host_rsun, kk, ksec, g_pri, g_sec, lnqmass, extra_ok=None,
               lnprior=None, **extra):
    """Assemble a conditioned twin dict (same field names as the normal
    branch so consumers are uniform)."""
    inc_rad, w_rad = _kernel_angles(tb["incs"], argps)
    mask = tb["geo_ok"] if extra_ok is None else tb["geo_ok"] & extra_ok
    n = P.shape[0]
    d = dict(P=P, qs=qs, eccs=eccs, argps=argps, masses=masses, radii=radii,
             fluxratios=fluxratios, a=tb["a"], incs=tb["incs"], b=tb["b"],
             mask=mask, lnw=tb["lnw"] + lnqmass, inc_rad=inc_rad,
             w_rad=w_rad, k=kk, ksec=ksec, g_pri=g_pri, g_sec=g_sec,
             a_R=tb["a"] / (R_host_rsun * RSUN),
             lnprior=jnp.zeros((n,), F32) if lnprior is None else lnprior)
    d.update(extra)
    return d


def _twin_alias(d):
    """Twin-branch view of a legacy shared-draw EB sampler output, so
    consumers can always read the twin branch as d['twin']."""
    N = d["P"].shape[0]
    t = dict(P=d["P"], qs=d["qs"], eccs=d["eccs"], argps=d["argps"],
             masses=d["masses"], radii=d["radii"],
             fluxratios=d["fluxratios"], a=d["a_twin"], incs=d["incs_twin"],
             b=d["b_twin"], mask=d["mask_twin"], lnw=d["lnw_twin"],
             inc_rad=d["inc_rad_twin"], w_rad=d["w_rad"],
             k=d.get("k_twin", d["k"]), ksec=d.get("ksec_twin", d["ksec"]),
             g_pri=d["g_pri"], g_sec=d["g_sec"], a_R=d["a_R_twin"],
             lnprior=d.get("lnprior", jnp.zeros((N,), F32)))
    for name in ("fluxratios_comp", "masses_comp", "radii_comp", "u1s",
                 "u2s", "idxs", "host_mass", "host_rad"):
        if name in d:
            t[name] = d[name]
    return t


def _eb_normal_branch(P, M_tot, R_host_rsun, radii_rsun, eccs, argps_deg,
                      u_inc, stratified):
    """Normal-branch geometry only (twin handled on its own conditioned
    draw set; see module notes)."""
    a, Ptra, coll, r = _geom_base(P, M_tot, R_host_rsun, radii_rsun * RSUN,
                                  eccs, argps_deg)
    incs, tra_ok, lnw = _inc_weighted(u_inc, Ptra, stratified)
    b = _impact_param(r, incs, R_host_rsun)
    return dict(a=a, incs=incs, b=b, geo_ok=tra_ok & ~coll, lnw=lnw)


def _eb_pack_normal(d, P, qs, eccs, argps, masses, radii, fluxratios,
                    nb, R_host_rsun, kk, ksec, g_pri, g_sec, extra_ok):
    """Normal-branch-only variant of _eb_pack (twin rides in d['twin'])."""
    inc_rad, w_rad = _kernel_angles(nb["incs"], argps)
    d.update(
        P=P, incs=nb["incs"], qs=qs, eccs=eccs, argps=argps, masses=masses,
        radii=radii, fluxratios=fluxratios, a=nb["a"], b=nb["b"],
        mask=nb["geo_ok"] & (qs < 0.95) & extra_ok, lnw=nb["lnw"],
        inc_rad=inc_rad, w_rad=w_rad, k=kk, ksec=ksec, g_pri=g_pri,
        g_sec=g_sec, a_R=nb["a"] / (R_host_rsun * RSUN))
    return d


def _eb_branches(P, M_tot, R_host_rsun, radii_rsun, eccs, argps_deg, u_inc,
                 twin_R_occ_cm, stratified):
    """Normal + twin-branch geometry for EB scenarios. The twin branch
    uses 2P and the caller-provided collision/transit radius
    (reference ml.py:253-268). Returns two dicts of per-branch arrays."""
    a, Ptra, coll, r = _geom_base(P, M_tot, R_host_rsun, radii_rsun * RSUN,
                                  eccs, argps_deg)
    incs, tra_ok, lnw = _inc_weighted(u_inc, Ptra, stratified)
    b = _impact_param(r, incs, R_host_rsun)

    a_twin = _semimajor(2.0 * P, M_tot)
    sin_argp = jnp.sin(argps_deg * PI / 180.0)
    e_corr = (1.0 + eccs * sin_argp) / (1.0 - eccs**2)
    R_host_cm = R_host_rsun * RSUN
    Ptra_twin = (radii_rsun * RSUN + R_host_cm) / a_twin * e_corr
    r_twin = a_twin * (1.0 - eccs**2) / (1.0 + eccs * sin_argp)
    coll_twin = twin_R_occ_cm > a_twin * (1.0 - eccs)
    incs_t, tra_ok_t, lnw_t = _inc_weighted(u_inc, Ptra_twin, stratified)
    b_twin = _impact_param(r_twin, incs_t, R_host_rsun)
    nb = dict(a=a, incs=incs, b=b, geo_ok=tra_ok & ~coll, lnw=lnw)
    tb = dict(a=a_twin, incs=incs_t, b=b_twin, geo_ok=tra_ok_t & ~coll_twin,
              lnw=lnw_t)
    return nb, tb


def _eb_pack(d, P, qs, eccs, argps, masses, radii, fluxratios,
             nb, tb, R_host_rsun, kk, ksec, g_pri, g_sec, extra_ok):
    inc_rad, w_rad = _kernel_angles(nb["incs"], argps)
    inc_rad_t, _ = _kernel_angles(tb["incs"], argps)
    d.update(
        P=P, incs=nb["incs"], incs_twin=tb["incs"], qs=qs, eccs=eccs,
        argps=argps, masses=masses, radii=radii, fluxratios=fluxratios,
        a=nb["a"], b=nb["b"], a_twin=tb["a"], b_twin=tb["b"],
        mask=nb["geo_ok"] & (qs < 0.95) & extra_ok,
        mask_twin=tb["geo_ok"] & (qs >= 0.95) & extra_ok,
        lnw=nb["lnw"], lnw_twin=tb["lnw"],
        inc_rad=inc_rad, inc_rad_twin=inc_rad_t, w_rad=w_rad,
        k=kk, ksec=ksec, g_pri=g_pri, g_sec=g_sec,
        a_R=nb["a"] / (R_host_rsun * RSUN),
        a_R_twin=tb["a"] / (R_host_rsun * RSUN))
    return d


def _teb_fields(key, P_lo, P_hi, M_s, R_s, Teff, n, twin):
    """Shared TEB field block; twin=True conditions q on the twin band."""
    u = _uniforms(key, 5, n)
    if twin:
        u = _lattice_strat(u, (1, 2, 4, 3), n, key)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], M_s)
    else:
        qs, lnqmass = sample_q(u[2], M_s), 0.0
    eccs = sample_ecc(u[3], False, jnp.mean(P))
    argps = sample_w(u[4])
    masses = qs * M_s
    radii, _ = stellar_relations(
        masses, jnp.full((n,), R_s, F32), jnp.full((n,), Teff, F32), xp=jnp)
    fluxratios = _fluxratio_vs_target(masses, M_s)
    kk, ksec = eb_radius_ratios(radii, R_s)
    F_EB = fluxratios / (1.0 - fluxratios)
    g_pri, g_sec = eb_dilution(F_EB, jnp.zeros((n,), F32), False)
    return u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios, \
        kk, ksec, g_pri, g_sec


@partial(jax.jit, static_argnames=("N", "stratified", "twin_n"))
def sample_teb(key, P_lo, P_hi, M_s, R_s, Teff, *, N, stratified=True,
               twin_n=0):
    """TEB / NEB: target (or nearby star) is an eclipsing binary
    (reference ml.py:175-383). twin_n > 0 (stratified only): the EBx2P
    branch runs on its own conditioned draw set (see module notes)."""
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios,
     kk, ksec, g_pri, g_sec) = _teb_fields(key, P_lo, P_hi, M_s, R_s, Teff,
                                           N, twin=False)
    if stratified and twin_n:
        nb = _eb_normal_branch(P, M_s + masses, R_s, radii, eccs, argps,
                               u[1], stratified)
        d = _eb_pack_normal({}, P, qs, eccs, argps, masses, radii,
                            fluxratios, nb, R_s, kk, ksec, g_pri, g_sec,
                            jnp.ones((N,), bool))
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt,
         kkt, ksect, g_prit, g_sect) = _teb_fields(
            jax.random.fold_in(key, 999), P_lo, P_hi, M_s, R_s, Teff,
            twin_n, twin=True)
        tbt = _twin_geom(Pt, M_s + massest, R_s, radiit, eccst, argpst,
                         ut[1], 2.0 * R_s * RSUN)
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, R_s, kkt, ksect, g_prit, g_sect, lnqm)
        return d
    nb, tb = _eb_branches(P, M_s + masses, R_s, radii, eccs, argps, u[1],
                          2.0 * R_s * RSUN, stratified)
    d = _eb_pack({}, P, qs, eccs, argps, masses, radii, fluxratios,
                 nb, tb, R_s, kk, ksec, g_pri, g_sec,
                 jnp.ones((N,), bool))
    d["twin"] = _twin_alias(d)
    return d


def _peb_fields(key, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps,
                cons, n, use_molusc, cc_filt, twin, lattice=True):
    """Shared PEB field block. twin=True conditions q on the twin band
    and resamples the companion set (molusc rows by random gather so the
    zero-padding proportion is preserved). lattice=True (any stratified
    call, normal or twin) Latin-hypercube-stratifies the (inc, q, w,
    ecc, q_comp) streams — the companion axis is the needle dimension that
    dominated the PEB key-to-key lnZ spread."""
    u = _uniforms(key, 6, n)
    if lattice:
        u = _lattice_strat(u, (1, 2, 4, 3, 5), n, key)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], M_s)
    else:
        qs, lnqmass = sample_q(u[2], M_s), 0.0
    eccs = sample_ecc(u[3], False, jnp.mean(P))
    argps = sample_w(u[4])
    if use_molusc:
        if twin:
            idx = jax.random.randint(jax.random.fold_in(key, 555), (n,), 0,
                                     qs_comp_in.shape[0])
            qs_comp = qs_comp_in[idx]
        else:
            qs_comp = qs_comp_in
    else:
        qs_comp = sample_q_companion(u[5], M_s)
    masses = qs * M_s
    radii, _ = stellar_relations(
        masses, jnp.full((n,), R_s, F32), jnp.full((n,), Teff, F32), xp=jnp)
    fluxratios = _fluxratio_vs_target(masses, M_s)
    masses_comp = qs_comp * M_s
    fluxratios_comp = _fluxratio_vs_target(masses_comp, M_s)
    if use_molusc:
        lnprior = jnp.zeros((n,), F32)
    else:
        lnprior = _companion_prior_bound(
            "EB", M_s, plx, masses_comp, fluxratios_comp, cc_filt, seps, cons)
    kk, ksec = eb_radius_ratios(radii, R_s)
    F_EB = fluxratios / (1.0 - fluxratios)
    F_comp = fluxratios_comp / (1.0 - fluxratios_comp)
    g_pri, g_sec = eb_dilution(F_EB, F_comp, False)
    return (u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios,
            qs_comp, fluxratios_comp, lnprior, kk, ksec, g_pri, g_sec)


@partial(jax.jit, static_argnames=("N", "use_molusc", "cc_filt", "stratified",
                                   "twin_n"))
def sample_peb(key, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps, cons,
               *, N, use_molusc, cc_filt, stratified=True, twin_n=0):
    """PEB: target EB + unresolved bound companion (reference ml.py:589-866)."""
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios, qs_comp,
     fluxratios_comp, lnprior, kk, ksec, g_pri, g_sec) = _peb_fields(
        key, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps, cons, N,
        use_molusc, cc_filt, twin=False, lattice=stratified)
    if stratified and twin_n:
        nb = _eb_normal_branch(P, M_s + masses, R_s, radii, eccs, argps,
                               u[1], stratified)
        d = _eb_pack_normal(dict(fluxratios_comp=fluxratios_comp,
                                 lnprior=lnprior),
                            P, qs, eccs, argps, masses, radii, fluxratios,
                            nb, R_s, kk, ksec, g_pri, g_sec, qs_comp != 0.0)
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt, qs_compt,
         fr_compt, lnpriort, kkt, ksect, g_prit, g_sect) = _peb_fields(
            jax.random.fold_in(key, 999), P_lo, P_hi, M_s, R_s, Teff, plx,
            qs_comp_in, seps, cons, twin_n, use_molusc, cc_filt, twin=True)
        tbt = _twin_geom(Pt, M_s + massest, R_s, radiit, eccst, argpst,
                         ut[1], 2.0 * R_s * RSUN)
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, R_s, kkt, ksect, g_prit, g_sect, lnqm,
                               extra_ok=qs_compt != 0.0, lnprior=lnpriort,
                               fluxratios_comp=fr_compt)
        return d
    nb, tb = _eb_branches(P, M_s + masses, R_s, radii, eccs, argps, u[1],
                          2.0 * R_s * RSUN, stratified)
    d = _eb_pack(dict(fluxratios_comp=fluxratios_comp, lnprior=lnprior),
                 P, qs, eccs, argps, masses, radii, fluxratios,
                 nb, tb, R_s, kk, ksec, g_pri, g_sec, qs_comp != 0.0)
    d["twin"] = _twin_alias(d)
    return d


def _seb_fields(key, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, u1_tab,
                u2_tab, seps, cons, n, use_molusc, cc_filt, twin,
                lattice=True):
    """Shared SEB field block (companion chain + per-draw LDC).
    lattice: see _peb_fields — the companion-host stream (axis 5) sets
    the whole dilution/LDC chain here, so it joins the lattice."""
    u = _uniforms(key, 6, n)
    if lattice:
        u = _lattice_strat(u, (1, 2, 4, 3, 5), n, key)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], M_s)
    else:
        qs, lnqmass = sample_q(u[2], M_s), 0.0
    eccs = sample_ecc(u[3], False, jnp.mean(P))
    argps = sample_w(u[4])
    if use_molusc:
        if twin:
            idx = jax.random.randint(jax.random.fold_in(key, 555), (n,), 0,
                                     qs_comp_in.shape[0])
            qs_comp = qs_comp_in[idx]
        else:
            qs_comp = qs_comp_in
    else:
        qs_comp = sample_q_companion(u[5], M_s)
    masses_comp = qs_comp * M_s
    radii_comp, teffs_comp = stellar_relations(
        masses_comp, jnp.full((n,), R_s, F32), jnp.full((n,), Teff, F32),
        xp=jnp)
    loggs_comp = jnp.log10(G * (masses_comp * MSUN) /
                           jnp.maximum(radii_comp * RSUN, 1.0) ** 2)
    fluxratios_comp = _fluxratio_vs_target(masses_comp, M_s)
    i_logg, i_teff = round_index_comp(loggs_comp, teffs_comp,
                                      u1_tab.shape[1], xp=jnp)
    u1s = u1_tab[i_logg, i_teff]
    u2s = u2_tab[i_logg, i_teff]
    masses = qs * masses_comp
    radii, _ = stellar_relations(masses, radii_comp, teffs_comp, xp=jnp)
    fluxratios = _fluxratio_vs_target(masses, M_s)
    if use_molusc:
        lnprior = jnp.zeros((n,), F32)
    else:
        if cc_filt is None:
            fr_c, fr_e = fluxratios_comp, fluxratios
        else:
            fr_c = _fluxratio_vs_target(masses_comp, M_s, cc_filt)
            fr_e = _fluxratio_vs_target(masses, M_s, cc_filt)
        delta_mags = 2.5 * jnp.log10(fr_c / (1.0 - fr_c) + fr_e / (1.0 - fr_e))
        lnp = lnprior_bound_EB(M_s, plx, jnp.abs(delta_mags), seps, cons)
        lnprior = clamp_companion_prior(lnp, delta_mags)
    kk, ksec = eb_radius_ratios(radii, radii_comp)
    F_EB = fluxratios / (1.0 - fluxratios)
    F_comp = fluxratios_comp / (1.0 - fluxratios_comp)
    g_pri, g_sec = eb_dilution(F_EB, F_comp, True)
    return (u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios,
            qs_comp, masses_comp, radii_comp, fluxratios_comp, u1s, u2s,
            lnprior, kk, ksec, g_pri, g_sec)


@partial(jax.jit, static_argnames=("N", "use_molusc", "cc_filt", "stratified",
                                   "twin_n"))
def sample_seb(key, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in,
               u1_tab, u2_tab, seps, cons, *, N, use_molusc, cc_filt,
               stratified=True, twin_n=0):
    """SEB: the unresolved bound companion is itself an EB
    (reference ml.py:1080-1376). Note the EB flux ratio denominator uses
    the *target* mass (ml.py:1193-1196) and the companion prior uses the
    combined companion+EB delta-mag (ml.py:1200-1235)."""
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios, qs_comp,
     masses_comp, radii_comp, fluxratios_comp, u1s, u2s, lnprior,
     kk, ksec, g_pri, g_sec) = _seb_fields(
        key, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, u1_tab, u2_tab,
        seps, cons, N, use_molusc, cc_filt, twin=False, lattice=stratified)
    extra = dict(fluxratios_comp=fluxratios_comp, lnprior=lnprior,
                 masses_comp=masses_comp, radii_comp=radii_comp,
                 u1s=u1s, u2s=u2s)
    if stratified and twin_n:
        nb = _eb_normal_branch(P, masses_comp + masses, radii_comp, radii,
                               eccs, argps, u[1], stratified)
        d = _eb_pack_normal(extra, P, qs, eccs, argps, masses, radii,
                            fluxratios, nb, radii_comp, kk, ksec, g_pri,
                            g_sec, qs_comp != 0.0)
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt, qs_compt,
         m_compt, r_compt, fr_compt, u1st, u2st, lnpriort, kkt, ksect,
         g_prit, g_sect) = _seb_fields(
            jax.random.fold_in(key, 999), P_lo, P_hi, M_s, R_s, Teff, plx,
            qs_comp_in, u1_tab, u2_tab, seps, cons, twin_n, use_molusc,
            cc_filt, twin=True)
        tbt = _twin_geom(Pt, m_compt + massest, r_compt, radiit, eccst,
                         argpst, ut[1], 2.0 * r_compt * RSUN)
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, r_compt, kkt, ksect, g_prit, g_sect,
                               lnqm, extra_ok=qs_compt != 0.0,
                               lnprior=lnpriort,
                               fluxratios_comp=fr_compt,
                               masses_comp=m_compt, radii_comp=r_compt,
                               u1s=u1st, u2s=u2st)
        return d
    nb, tb = _eb_branches(P, masses_comp + masses, radii_comp, radii, eccs,
                          argps, u[1], 2.0 * radii_comp * RSUN, stratified)
    d = _eb_pack(extra, P, qs, eccs, argps, masses, radii, fluxratios,
                 nb, tb, radii_comp, kk, ksec, g_pri, g_sec,
                 qs_comp != 0.0)
    d["twin"] = _twin_alias(d)
    return d


def _bg_eb_fields(key, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons, n,
                  has_cc, host_is_bg, cc_filt, N_comp, twin):
    """Shared DEB/BEB field block (own bg-row draws per call)."""
    u = _uniforms(key, 5, n)
    if twin:
        u = _lattice_strat(u, (1, 2, 4, 3), n, key)
    key_idx = jax.random.fold_in(key, 777)
    hi = N_comp if host_is_bg else jnp.maximum(N_comp - 1, 1)
    idxs = jax.random.randint(key_idx, (n,), 0, hi)
    row = _drawn_rows(bg, idxs, BG_PACK_FIELDS)
    fluxratios_draw = row["fluxratios"]
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], M_s)
    else:
        qs, lnqmass = sample_q(u[2], M_s), 0.0
    eccs = sample_ecc(u[3], False, jnp.mean(P))
    argps = sample_w(u[4])
    if host_is_bg:
        host_mass = row["masses"]
        host_rad = row["radii"]
        u1s, u2s = row["u1s"], row["u2s"]
        pop_ok = (row["loggs"] >= 3.5) & (row["teffs"] <= 10000.0)
        masses = qs * host_mass
        radii, _ = stellar_relations(masses, host_rad, row["teffs"], xp=jnp)
        fr_bound = _fluxratio_vs_target(host_mass, M_s)
        dist_corr = fluxratios_draw / fr_bound
        fluxratios = _fluxratio_vs_target(masses, M_s) * dist_corr
        F_comp = fluxratios_draw / (1.0 - fluxratios_draw)
        g_pri, g_sec = eb_dilution(fluxratios / (1.0 - fluxratios), F_comp, True)
    else:
        host_mass = jnp.full((n,), M_s, F32)
        host_rad = jnp.full((n,), R_s, F32)
        u1s = u2s = None
        pop_ok = jnp.ones((n,), bool)
        masses = qs * M_s
        radii, _ = stellar_relations(
            masses, jnp.full((n,), R_s, F32), jnp.full((n,), Teff, F32), xp=jnp)
        fluxratios = _fluxratio_vs_target(masses, M_s)
        F_comp = fluxratios_draw / (1.0 - fluxratios_draw)
        g_pri, g_sec = eb_dilution(fluxratios / (1.0 - fluxratios), F_comp, False)
    # background prior. BEB combines the companion and EB flux ratios in
    # the delta-mag; with a contrast curve both get the cc-band distance
    # correction (ml.py:2160-2209). DEB uses the DTP-style block
    # (ml.py:1674-1701).
    if host_is_bg:
        if has_cc:
            fr_c_cc = row["fluxratios_cc"]
            fr_bound_cc = _fluxratio_vs_target(host_mass, M_s, cc_filt)
            fr_eb_cc = (_fluxratio_vs_target(masses, M_s, cc_filt)
                        * (fr_c_cc / fr_bound_cc))
            delta_mags = 2.5 * jnp.log10(fr_c_cc / (1.0 - fr_c_cc)
                                         + fr_eb_cc / (1.0 - fr_eb_cc))
            lnp = lnprior_background(N_comp, jnp.abs(delta_mags), seps, cons)
        else:
            delta_mags = 2.5 * jnp.log10(
                fluxratios_draw / (1.0 - fluxratios_draw)
                + fluxratios / (1.0 - fluxratios))
            lnp = (jnp.zeros_like(delta_mags)
                   + jnp.log((N_comp / 0.1) * (1.0 / 3600.0) ** 2 * 2.2**2))
        lnprior = clamp_companion_prior(lnp, delta_mags)
    else:
        lnprior = _background_prior(has_cc, N_comp, fluxratios_draw,
                                    row["delta_band"], seps, cons)
    kk, ksec = eb_radius_ratios(radii, host_rad)
    return (u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios,
            fluxratios_draw, idxs, host_mass, host_rad, u1s, u2s, pop_ok,
            lnprior, kk, ksec, g_pri, g_sec)


@partial(jax.jit, static_argnames=("N", "has_cc", "host_is_bg", "cc_filt",
                                   "stratified", "twin_n"))
def sample_background_eb(key, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons,
                         *, N, has_cc, host_is_bg, cc_filt="TESS",
                         stratified=True, n_comp=None, twin_n=0):
    """DEB (host_is_bg=False) and BEB (host_is_bg=True)
    (reference ml.py:1571-1837 DEB, :2038-2362 BEB). BEB applies the
    distance correction to the EB flux ratio (ml.py:2146-2159).
    n_comp: optional traced population count (see
    sample_background_planet)."""
    N_comp = bg["fluxratios"].shape[0] if n_comp is None else n_comp
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios, fluxratios_draw,
     idxs, host_mass, host_rad, u1s, u2s, pop_ok, lnprior,
     kk, ksec, g_pri, g_sec) = _bg_eb_fields(
        key, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons, N, has_cc,
        host_is_bg, cc_filt, N_comp, twin=False)
    extra = dict(fluxratios_comp=fluxratios_draw, lnprior=lnprior, idxs=idxs,
                 host_mass=host_mass, host_rad=host_rad)
    if u1s is not None:
        extra["u1s"], extra["u2s"] = u1s, u2s
    if stratified and twin_n:
        nb = _eb_normal_branch(P, host_mass + masses, host_rad, radii, eccs,
                               argps, u[1], stratified)
        d = _eb_pack_normal(extra, P, qs, eccs, argps, masses, radii,
                            fluxratios, nb, host_rad, kk, ksec, g_pri,
                            g_sec, pop_ok)
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt, fr_drawt,
         idxst, h_mt, h_rt, u1st, u2st, pop_okt, lnpriort,
         kkt, ksect, g_prit, g_sect) = _bg_eb_fields(
            jax.random.fold_in(key, 999), P_lo, P_hi, M_s, R_s, Teff, bg,
            seps, cons, twin_n, has_cc, host_is_bg, cc_filt, N_comp,
            twin=True)
        tbt = _twin_geom(Pt, h_mt + massest, h_rt, radiit, eccst, argpst,
                         ut[1], 2.0 * h_rt * RSUN)
        textra = dict(fluxratios_comp=fr_drawt, idxs=idxst,
                      host_mass=h_mt, host_rad=h_rt)
        if u1st is not None:
            textra["u1s"], textra["u2s"] = u1st, u2st
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, h_rt, kkt, ksect, g_prit, g_sect, lnqm,
                               extra_ok=pop_okt, lnprior=lnpriort, **textra)
        return d
    nb, tb = _eb_branches(P, host_mass + masses, host_rad, radii, eccs,
                          argps, u[1], 2.0 * host_rad * RSUN, stratified)
    d = _eb_pack(extra, P, qs, eccs, argps, masses, radii, fluxratios,
                 nb, tb, host_rad, kk, ksec, g_pri, g_sec, pop_ok)
    d["twin"] = _twin_alias(d)
    return d


def _neb_evolved_fields(key, P_lo, P_hi, M_s, R_s, Teff, n, twin):
    u = _uniforms(key, 5, n)
    if twin:
        u = _lattice_strat(u, (1, 2, 4, 3), n, key)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], 1.0)
    else:
        qs, lnqmass = sample_q(u[2], 1.0), 0.0
    eccs = sample_ecc(u[3], False, jnp.mean(P))
    argps = sample_w(u[4])
    masses = qs * M_s
    radii, _ = stellar_relations(
        masses, jnp.full((n,), R_s, F32), jnp.full((n,), Teff, F32), xp=jnp)
    fluxratios = _fluxratio_vs_target(masses, M_s)
    F_EB = fluxratios / (1.0 - fluxratios)
    g_pri, g_sec = eb_dilution(F_EB, jnp.zeros((n,), F32), False)
    return (u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios,
            g_pri, g_sec)


@partial(jax.jit, static_argnames=("N", "stratified", "twin_n"))
def sample_neb_evolved(key, P_lo, P_hi, M_s, R_s, Teff, *, N,
                       stratified=True, twin_n=0):
    """NEB for subgiant stars (logg=3.0 assumption; M_s derived on host)
    (reference ml.py:2969-3178). Twin-branch quirks preserved: Ptra_twin
    uses (R_s + R_s) instead of (radii + R_s) (ml.py:3052) and the twin
    lnL call passes R_EB = R_s so the twin radius ratio is exactly 1
    before the 0.999 adjustment (ml.py:3100)."""
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios,
     g_pri, g_sec) = _neb_evolved_fields(key, P_lo, P_hi, M_s, R_s, Teff,
                                         N, twin=False)
    # normal branch
    a, Ptra, coll, r = _geom_base(P, M_s + masses, R_s, radii * RSUN,
                                  eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[1], Ptra, stratified)
    b = _impact_param(r, incs, R_s)
    inc_rad, w_rad = _kernel_angles(incs, argps)
    kk, ksec = eb_radius_ratios(radii, R_s)
    d = dict(P=P, incs=incs, qs=qs, eccs=eccs, argps=argps, masses=masses,
             radii=radii, fluxratios=fluxratios, a=a, b=b,
             mask=tra_ok & ~coll & (qs < 0.95), lnw=lnw,
             inc_rad=inc_rad, w_rad=w_rad, k=kk, ksec=ksec,
             g_pri=g_pri, g_sec=g_sec, a_R=a / (R_s * RSUN))
    if stratified and twin_n:
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt,
         g_prit, g_sect) = _neb_evolved_fields(
            jax.random.fold_in(key, 999), P_lo, P_hi, M_s, R_s, Teff,
            twin_n, twin=True)
        # twin quirks: Ptra/collision radius 2*R_s; k = ksec from
        # R_EB = R_s exactly (the 0.999 adjustment)
        tbt = _twin_geom(Pt, M_s + massest, R_s, radiit, eccst, argpst,
                         ut[1], 2.0 * R_s * RSUN,
                         Ptra_R_occ_cm=2.0 * R_s * RSUN)
        k_t, ksec_t = eb_radius_ratios(jnp.full((twin_n,), R_s, F32), R_s)
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, R_s, k_t, ksec_t, g_prit, g_sect, lnqm)
        return d
    # legacy shared-draw twin branch with the 2*R_s quirks
    a_twin = _semimajor(2.0 * P, M_s + masses)
    sin_argp = jnp.sin(argps * PI / 180.0)
    e_corr = (1.0 + eccs * sin_argp) / (1.0 - eccs**2)
    Ptra_twin = (2.0 * R_s * RSUN) / a_twin * e_corr  # quirk: 2*R_s
    r_twin = a_twin * (1.0 - eccs**2) / (1.0 + eccs * sin_argp)
    coll_twin = (2.0 * R_s * RSUN) > a_twin * (1.0 - eccs)
    incs_t, tra_ok_t, lnw_t = _inc_weighted(u[1], Ptra_twin, stratified)
    b_twin = _impact_param(r_twin, incs_t, R_s)
    inc_rad_t, _ = _kernel_angles(incs_t, argps)
    # twin branch: R_EB = R_s exactly -> k = ksec = 1 -> 0.999 adjustment
    k_twin, ksec_twin = eb_radius_ratios(jnp.full((N,), R_s, F32), R_s)
    d.update(incs_twin=incs_t, a_twin=a_twin, b_twin=b_twin,
             mask_twin=tra_ok_t & ~coll_twin & (qs >= 0.95),
             lnw_twin=lnw_t, inc_rad_twin=inc_rad_t,
             k_twin=k_twin, ksec_twin=ksec_twin,
             a_R_twin=a_twin / (R_s * RSUN))
    d["twin"] = _twin_alias(d)
    return d


def _neb_unknown_fields(key, P_lo, P_hi, pop, n, twin):
    u = _uniforms(key, 5, n)
    if twin:
        u = _lattice_strat(u, (1, 2, 4, 3), n, key)
    key_idx = jax.random.fold_in(key, 777)
    N_pos = pop["masses"].shape[0]
    idxs = jax.random.randint(key_idx, (n,), 0, N_pos)
    row = _drawn_rows(pop, idxs, POP_PACK_FIELDS)
    host_mass = row["masses"]
    host_rad = row["radii"]
    u1s, u2s = row["u1s"], row["u2s"]
    pop_ok = (row["loggs"] >= 3.5) & (row["teffs"] <= 10000.0)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], 1.0)
    else:
        qs, lnqmass = sample_q(u[2], 1.0), 0.0
    eccs = sample_ecc(u[3], False, jnp.mean(P))
    argps = sample_w(u[4])
    masses = qs * host_mass
    radii, _ = stellar_relations(masses, host_rad, row["teffs"], xp=jnp)
    f_eb = flux_relation(masses, "TESS", xp=jnp)
    f_host = flux_relation(host_mass, "TESS", xp=jnp)
    fluxratios = f_eb / (f_eb + f_host)
    kk, ksec = eb_radius_ratios(radii, host_rad)
    F_EB = fluxratios / (1.0 - fluxratios)
    g_pri, g_sec = eb_dilution(F_EB, jnp.zeros((n,), F32), False)
    return (u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios,
            idxs, host_mass, host_rad, u1s, u2s, pop_ok, kk, ksec,
            g_pri, g_sec)


@partial(jax.jit, static_argnames=("N", "stratified", "twin_n"))
def sample_neb_unknown(key, P_lo, P_hi, pop, *, N, stratified=True,
                       twin_n=0):
    """NEB for a star of unknown properties (reference ml.py:2554-2829).
    qs drawn with M_s=1.0; EB flux ratio is relative to the drawn host
    (ml.py:2672-2676)."""
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios, idxs,
     host_mass, host_rad, u1s, u2s, pop_ok, kk, ksec,
     g_pri, g_sec) = _neb_unknown_fields(key, P_lo, P_hi, pop, N,
                                         twin=False)
    extra = dict(idxs=idxs, host_mass=host_mass, host_rad=host_rad,
                 u1s=u1s, u2s=u2s, g=jnp.ones((N,), F32),
                 lnprior=jnp.zeros((N,), F32))
    if stratified and twin_n:
        nb = _eb_normal_branch(P, host_mass + masses, host_rad, radii, eccs,
                               argps, u[1], stratified)
        d = _eb_pack_normal(extra, P, qs, eccs, argps, masses, radii,
                            fluxratios, nb, host_rad, kk, ksec, g_pri,
                            g_sec, pop_ok)
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt, idxst,
         h_mt, h_rt, u1st, u2st, pop_okt, kkt, ksect,
         g_prit, g_sect) = _neb_unknown_fields(
            jax.random.fold_in(key, 999), P_lo, P_hi, pop, twin_n,
            twin=True)
        tbt = _twin_geom(Pt, h_mt + massest, h_rt, radiit, eccst, argpst,
                         ut[1], 2.0 * h_rt * RSUN)
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, h_rt, kkt, ksect, g_prit, g_sect, lnqm,
                               extra_ok=pop_okt, idxs=idxst,
                               host_mass=h_mt, host_rad=h_rt,
                               u1s=u1st, u2s=u2st)
        return d
    nb, tb = _eb_branches(P, host_mass + masses, host_rad, radii, eccs,
                          argps, u[1], 2.0 * host_rad * RSUN, stratified)
    d = _eb_pack(extra, P, qs, eccs, argps, masses, radii, fluxratios,
                 nb, tb, host_rad, kk, ksec, g_pri, g_sec, pop_ok)
    d["twin"] = _twin_alias(d)
    return d
