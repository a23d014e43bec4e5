"""Multi-chip execution: target-batch data parallelism x draw sharding.

The workload's parallel axes (SURVEY.md section 2.4) map onto a 2-D
``jax.sharding.Mesh``:

* ``targets`` axis — catalog replay is embarrassingly parallel across
  TOIs (pure data parallel; per-target reductions are chip-local).
* ``draws`` axis — a single target's Monte-Carlo draw axis is sharded so
  one FPP can use many chips; the only cross-chip communication is the
  evidence reduction, a pmax/psum logsumexp across the draws axis.

``batch_fpp_tp_eb`` runs the core scenario set (TP, EB, EBx2P — the
minimum end-to-end slice of SURVEY.md section 7) for a batch of targets
under ``shard_map``; draws are i.i.d. per (target, draw-shard) via folded
keys, so sharding changes the random stream but not the estimator.

``batch_fpp_full`` runs ALL 15 target-star scenarios (the full
calc_probs taxonomy for the target star, reference triceratops.py:
716-1340: TP, EB, EBx2P, PTP, PEB, PEBx2P, STP, SEB, SEBx2P, DTP, DEB,
DEBx2P, BTP, BEB, BEBx2P) with the bound-companion and background
priors, per-target TRILEGAL tables (padded to a common length,
replicated across the draws axis), and optional contrast curves.
``prepare_target_batch`` assembles the stacked per-target host inputs.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.numerics import logsumexp_jax
from ..ops.lightcurve import lnL_planet, lnL_eb
from ..scenarios import engine as eng


def make_mesh(n_devices: int | None = None, n_target_shards: int = 1,
              devices=None):
    """A ('targets', 'draws') mesh over the available devices.

    ``devices`` pins an explicit device list (e.g. ``jax.devices("cpu")``
    when the default backend already initialized against another
    platform); default is the default-platform devices.
    """
    pool = list(devices) if devices is not None else jax.devices()
    devs = np.array(pool[: n_devices or len(pool)])
    nt = n_target_shards
    nd = len(devs) // nt
    if nd < 1:
        raise ValueError(
            f"mesh needs >= {nt} devices for {nt} target shards but only "
            f"{len(devs)} are available (default platform "
            f"{jax.default_backend()!r}; pass devices= to pin a platform)")
    return Mesh(devs[: nt * nd].reshape(nt, nd), ("targets", "draws"))


def _local_lnZ_parts(lnL):
    """(local max, local scaled sumexp) for a distributed logsumexp."""
    finite = jnp.isfinite(lnL)
    safe = jnp.where(finite, lnL, -jnp.inf)
    m = jnp.max(safe)
    m_safe = jnp.where(jnp.isfinite(m), m, -1e30)
    s = jnp.sum(jnp.where(finite, jnp.exp(safe - m_safe), 0.0))
    return m_safe, s


def _combine_lnZ(m, s, N_total, axis_name):
    """Cross-chip logsumexp - log(N_total) over the draws axis."""
    M = jax.lax.pmax(m, axis_name)
    S = jax.lax.psum(s * jnp.exp(m - M), axis_name)
    lnZ = M + jnp.log(S) - jnp.log(float(N_total))
    return jnp.where(S > 0.0, lnZ, -jnp.inf)


def batch_fpp_tp_eb(mesh: Mesh, keys, times, obs_dev, sigmas, P_orbs,
                    M_ss, R_ss, Teffs, u1s, u2s, *, N: int, n_t: int,
                    ns: int, chunk: int = 1024, exptime: float = 0.00139):
    """FPP over the (TP, EB, EBx2P) scenario set for a batch of targets.

    Batch axis is sharded over 'targets'; each target's N draws are split
    over 'draws' (each shard draws N / n_d i.i.d. samples from a folded
    key). Returns (FPP, lnZ[3]) per target.

    Args are per-target arrays: keys (B,), times (B, n_t) exposure
    centers, obs_dev (B, n_t) flux - 1, scalars (B,).
    """
    n_d = mesh.shape["draws"]
    if N % n_d:
        raise ValueError(f"N={N} must divide the draws axis ({n_d})")
    N_local = N // n_d

    def per_target(key, time_i, obs_i, sigma, P_orb, M_s, R_s, Teff, u1, u2):
        d_idx = jax.lax.axis_index("draws")
        key = jax.random.fold_in(key, d_idx)
        k_tp, k_eb = jax.random.split(key)
        u1a = jnp.full((N_local,), u1, jnp.float32)
        u2a = jnp.full((N_local,), u2, jnp.float32)

        d = eng.sample_planet_target(k_tp, P_orb, P_orb, M_s, R_s,
                                     N=N_local, flatpriors=False)
        lnL_tp = lnL_planet(time_i, obs_i, sigma, d["k"], d["P"], d["a_R"],
                            d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                            jnp.ones((N_local,), jnp.float32), d["mask"],
                            exptime=exptime, n_t=n_t, ns=ns, chunk=chunk)
        twin_local = max(N_local // eng.TWIN_DIV, 1)
        e = eng.sample_teb(k_eb, P_orb, P_orb, M_s, R_s, Teff, N=N_local,
                           twin_n=twin_local)
        t = e["twin"]
        nt = t["P"].shape[0]
        lnL_eb_ = lnL_eb(time_i, obs_i, sigma, e["k"], e["ksec"], e["P"],
                         e["a_R"], e["inc_rad"], e["eccs"], e["w_rad"],
                         u1a, u2a, e["g_pri"], e["g_sec"], e["mask"],
                         exptime=exptime, n_t=n_t, ns=ns, chunk=chunk,
                         apply_veto=True)
        lnL_twin = lnL_eb(time_i, obs_i, sigma, t["k"], t["ksec"],
                          2.0 * t["P"], t["a_R"], t["inc_rad"],
                          t["eccs"], t["w_rad"], u1a[:nt], u2a[:nt],
                          t["g_pri"], t["g_sec"], t["mask"],
                          exptime=exptime, n_t=n_t, ns=ns, chunk=chunk,
                          apply_veto=False)
        lnZs = []
        for lnL, lnw, n_tot in ((lnL_tp, d["lnw"], N),
                                (lnL_eb_, e["lnw"], N),
                                (lnL_twin, t["lnw"], nt * n_d)):
            m, s = _local_lnZ_parts(lnL + lnw)
            lnZs.append(_combine_lnZ(m, s, n_tot, "draws"))
        lnZ = jnp.stack(lnZs)
        probs = jnp.exp(lnZ - logsumexp_jax(lnZ))
        fpp = 1.0 - probs[0]
        return fpp, lnZ

    @partial(shard_map, mesh=mesh,
             in_specs=(P("targets"),) * 10,
             out_specs=(P("targets"), P("targets")),
             check_vma=False)
    def step(keys, times, obs_dev, sigmas, P_orbs, M_ss, R_ss, Teffs,
             u1s, u2s):
        return jax.vmap(per_target)(keys, times, obs_dev, sigmas, P_orbs,
                                    M_ss, R_ss, Teffs, u1s, u2s)

    return jax.jit(step)(keys, times, obs_dev, sigmas, P_orbs, M_ss, R_ss,
                         Teffs, u1s, u2s)


# ---------------------------------------------------------------------------
# Full 15-scenario sharded FPP (the complete target-star taxonomy)
# ---------------------------------------------------------------------------

# scenario row order = the reference's calc_probs target-star block
# (triceratops.py:797-1340)
FULL_SCENARIOS = ("TP", "EB", "EBx2P", "PTP", "PEB", "PEBx2P",
                  "STP", "SEB", "SEBx2P", "DTP", "DEB", "DEBx2P",
                  "BTP", "BEB", "BEBx2P")
_BG_FIELDS = ("fluxratios", "delta_band", "masses", "radii", "loggs",
              "teffs", "u1s", "u2s", "fluxratios_cc")


def prepare_target_batch(targets: list[dict], mission: str = "TESS"):
    """Stack per-target host inputs into the device-ready batch dict for
    ``batch_fpp_full``.

    Each element of ``targets`` is a dict with keys: time (n_t,), flux
    (n_t,), sigma, P_orb, M_s, R_s, Teff, Z, plx, Tmag, Jmag, Hmag, Kmag,
    trilegal_fname, and optionally key (jax PRNG key), contrast_curve
    (seps, cons) arrays, and nearby — a list of dicts (mass, rad, Teff,
    Z, fluxratio, tdepth) for the resolved nearby stars that passed the
    tdepth > 0 gate (NTP/NEB/NEBx2P rows -> NFPP; NaN stellar properties
    get the reference's solar fallbacks, triceratops.py:1344-1363).
    Light curves must share one n_t (one compiled program per shape).
    TRILEGAL tables are padded to the longest by repeating the last row;
    the true count rides in n_comp so padded rows are never drawn;
    nearby slots are padded to the max count with valid = False.

    A per-target ``molusc_file`` (MOLUSC companion posterior replacing
    the analytic companion draw in the P*/S* scenarios, reference
    ml.py:455-464) is supported batch-wide: either every target carries
    one or none does (the molusc switch is a compile-time branch of the
    scenario programs). The kept mass-ratio rows are padded to a common
    length with the true counts in ``molusc_kept``; the per-draw zero
    fraction 1 - kept/N (the reference's zero-padding semantics) is
    reproduced inside the scenario programs.
    """
    import jax.random as jrandom
    from ..scenarios.api import _prep_background
    from ..populations.ldc import lookup_target, grid_at_Z
    from ..populations.molusc import load_molusc_kept

    B = len(targets)
    n_t = len(targets[0]["time"])
    f32 = np.float32
    bg_list, ncomp = [], []
    for t in targets:
        bg_i, n_i = _prep_background(t["trilegal_fname"], t["Tmag"],
                                     t["Jmag"], t["Hmag"], t["Kmag"],
                                     mission, t.get("filt", "TESS"),
                                     need_ldc=True, need_cc_ratio=True)
        bg_list.append({k: np.asarray(bg_i[k]) for k in _BG_FIELDS})
        ncomp.append(n_i)
    n_bg = max(len(b["fluxratios"]) for b in bg_list)
    bg = {k: np.stack([np.concatenate(
            [b[k], np.repeat(b[k][-1:], n_bg - len(b[k]), axis=0)])
          for b in bg_list]) for k in _BG_FIELDS}
    # packed (B, n_bg, F) table: one row gather per draw in the samplers
    bg["pack"] = np.stack([bg[f] for f in eng.BG_PACK_FIELDS], axis=-1)

    u1 = np.zeros(B, f32)
    u2 = np.zeros(B, f32)
    tabs10, tabs13 = [], []
    for i, t in enumerate(targets):
        from ..constants import G, MSUN, RSUN
        logg = float(np.log10(G * (t["M_s"] * MSUN) / (t["R_s"] * RSUN) ** 2))
        u1[i], u2[i] = lookup_target(t["Z"], t["Teff"], logg, mission)
        tabs10.append(grid_at_Z(t["Z"], mission, teff_max=10000))
        tabs13.append(grid_at_Z(t["Z"], mission, teff_max=13000))

    has_cc = any("contrast_curve" in t for t in targets)
    n_cc = max((len(t["contrast_curve"][0]) for t in targets
                if "contrast_curve" in t), default=1)
    seps = np.full((B, n_cc), 2.2, f32)
    cons = np.full((B, n_cc), 1.0, f32)
    for i, t in enumerate(targets):
        if "contrast_curve" in t:
            s_i, c_i = (np.asarray(a, f32) for a in t["contrast_curve"])
            pad = n_cc - len(s_i)
            seps[i] = np.concatenate([s_i, np.repeat(s_i[-1:], pad)])
            cons[i] = np.concatenate([c_i, np.repeat(c_i[-1:], pad)])

    col = lambda name, d=f32: np.asarray(  # noqa: E731
        [t[name] for t in targets], dtype=d)
    batch = dict(
        key=jnp.stack([t.get("key", jrandom.key(i))
                       for i, t in enumerate(targets)]),
        time=np.stack([np.asarray(t["time"], f32) for t in targets]),
        obs_dev=np.stack([np.asarray(t["flux"], np.float64) - 1.0
                          for t in targets]).astype(f32),
        sigma=col("sigma"), P_orb=col("P_orb"), M_s=col("M_s"),
        R_s=col("R_s"), Teff=col("Teff"), plx=col("plx"),
        u1=u1, u2=u2,
        u1_tab10=np.stack([a for a, _ in tabs10]).astype(f32),
        u2_tab10=np.stack([b for _, b in tabs10]).astype(f32),
        u1_tab13=np.stack([a for a, _ in tabs13]).astype(f32),
        u2_tab13=np.stack([b for _, b in tabs13]).astype(f32),
        bg=bg, n_comp=np.asarray(ncomp, np.int32),
        seps=seps, cons=cons,
    )
    n_molusc = sum("molusc_file" in t for t in targets)
    if n_molusc not in (0, B):
        raise ValueError(
            f"molusc_file set on {n_molusc}/{B} targets: the molusc "
            "switch is batch-wide (all targets or none)")
    if n_molusc:
        kept = [load_molusc_kept(t["molusc_file"], t["M_s"])
                for t in targets]
        n_q = max(max(len(q) for q in kept), 1)
        batch["molusc_qs"] = np.stack(
            [np.pad(np.asarray(q, f32), (0, n_q - len(q))) for q in kept])
        batch["molusc_kept"] = np.asarray([len(q) for q in kept], np.int32)

    K = max((len(t.get("nearby", ())) for t in targets), default=0)
    if K > 0:
        nb = {k: np.zeros((B, K), f32) for k in
              ("M_s", "R_s", "Teff", "u1", "u2", "fluxratio")}
        nb["valid"] = np.zeros((B, K), bool)
        nb["fluxratio"][:] = 1.0
        nb["M_s"][:] = 1.0
        nb["R_s"][:] = 1.0
        nb["Teff"][:] = 5780.0
        for i, t in enumerate(targets):
            for kk, s in enumerate(t.get("nearby", ())):
                m_k = s.get("mass", np.nan)
                r_k = s.get("rad", np.nan)
                T_k = s.get("Teff", np.nan)
                nb["M_s"][i, kk] = 1.0 if np.isnan(m_k) else m_k
                nb["R_s"][i, kk] = 1.0 if np.isnan(r_k) else r_k
                nb["Teff"][i, kk] = 5780.0 if np.isnan(T_k) else T_k
                nb["fluxratio"][i, kk] = s["fluxratio"]
                nb["valid"][i, kk] = True
                from ..constants import G, MSUN, RSUN
                logg = float(np.log10(G * (nb["M_s"][i, kk] * MSUN)
                                      / (nb["R_s"][i, kk] * RSUN) ** 2))
                nb["u1"][i, kk], nb["u2"][i, kk] = lookup_target(
                    s.get("Z", 0.0), nb["Teff"][i, kk], logg, mission)
        batch["nearby"] = nb
    batch = {k: (v if k in ("bg", "nearby") else jnp.asarray(v))
             for k, v in batch.items()}
    batch["bg"] = {k: jnp.asarray(v) for k, v in batch["bg"].items()}
    if K > 0:
        batch["nearby"] = {k: jnp.asarray(v)
                           for k, v in batch["nearby"].items()}
    return batch, n_t, has_cc


def batch_fpp_full(mesh: Mesh, batch: dict, *, N: int, n_t: int, ns: int,
                   chunk: int = 1024, exptime: float = 0.00139,
                   flatpriors: bool = False, has_cc: bool = False,
                   cc_filt: str | None = None,
                   drop_scenario: tuple = ()):
    """FPP/NFPP over the full scenario taxonomy for a batch of targets:
    the 15 target-star scenarios plus NTP/NEB/NEBx2P per nearby-star
    slot when the batch carries a 'nearby' block
    (reference triceratops.py:716-1428).

    The batch axis shards over 'targets'; each target's N draws split
    over 'draws' (i.i.d. per shard via folded keys); the only cross-chip
    communication is the per-scenario evidence logsumexp.
    Returns (FPP, NFPP, lnZ (B, 15 + 3K)) ordered as FULL_SCENARIOS then
    (NTP, NEB, NEBx2P) per slot; FPP = 1 - (P_TP + P_PTP + P_DTP),
    NFPP = sum of the nearby-star probabilities (triceratops.py:
    1479-1483). Invalid (padding) slots carry lnZ = -inf.

    ``batch`` comes from ``prepare_target_batch`` (or hand-assembled
    arrays with the same keys). ``cc_filt`` must be set when has_cc.
    ``drop_scenario`` names from FULL_SCENARIOS get lnZ = -inf (the
    reference's semantics, triceratops.py:784-789; like the frontend,
    nearby-star rows cannot be dropped — docs/parity.md item 9).
    """
    n_d = mesh.shape["draws"]
    if N % n_d:
        raise ValueError(f"N={N} must divide the draws axis ({n_d})")
    eff_cc_filt = cc_filt if has_cc else None
    unknown = set(drop_scenario) - set(FULL_SCENARIOS)
    nearby_rows = unknown & {"NTP", "NEB", "NEBx2P"}
    if nearby_rows:
        raise ValueError(
            f"drop_scenario cannot drop nearby-star rows {sorted(nearby_rows)}: "
            "like the frontend, batch_fpp_full only drops target-star "
            "scenarios (docs/parity.md item 9)")
    if unknown:
        raise ValueError(f"unknown drop_scenario entries: {sorted(unknown)}")
    drop_idx = tuple(i for i, s in enumerate(FULL_SCENARIOS)
                     if s in drop_scenario)
    use_molusc = "molusc_qs" in batch
    cfg = (N, n_t, ns, chunk, exptime, flatpriors, has_cc, eff_cc_filt,
           use_molusc)
    core = {k: v for k, v in batch.items() if k != "nearby"}
    B = batch["key"].shape[0]

    # one jitted sharded program per scenario FAMILY, all enqueued
    # before anything is pulled: on one device this keeps the serial
    # path's async-dispatch overlap (one big fused program cannot
    # overlap host prep/dispatch with device compute); on many devices
    # each program shards identically to a fused step.
    rows = [None] * 15
    for fam, idxs in _FAMILY_ROWS:
        if set(idxs) <= set(drop_idx):
            continue
        out = _build_family_step(mesh, fam, cfg)(core)
        for i, z in zip(idxs, out):
            rows[i] = z
    neg = jnp.full((B,), -jnp.inf, jnp.float32)
    rows = [neg if z is None or i in drop_idx else z
            for i, z in enumerate(rows)]

    nearby = batch.get("nearby")
    if nearby is not None:
        K = nearby["valid"].shape[1]
        for kk in range(K):
            sub = dict(core)
            sub["nb_slot"] = jnp.full((B,), kk, jnp.int32)
            for f in ("M_s", "R_s", "Teff", "u1", "u2", "fluxratio"):
                sub["nb_" + f] = nearby[f][:, kk]
            sub["nb_valid"] = nearby["valid"][:, kk]
            for fam in ("NTP", "NEB"):
                out = _build_family_step(mesh, fam, cfg)(sub)
                rows.extend(out)

    lnZv = jnp.stack(rows, axis=1)  # (B, 15 + 3K)
    return _combine_rows(lnZv)


@jax.jit
def _combine_rows(lnZv):
    """(FPP, NFPP, lnZ) from the stacked per-scenario evidences
    (reference triceratops.py:1431-1483)."""
    norm = jax.vmap(lambda z: jnp.exp(z - logsumexp_jax(z)))
    probs = norm(lnZv)
    fpp = jnp.maximum(1.0 - (probs[:, 0] + probs[:, 3] + probs[:, 9]), 0.0)
    if lnZv.shape[1] > 15:
        nfpp = jnp.sum(probs[:, 15:], axis=1)
    else:
        nfpp = jnp.zeros_like(fpp)
    return fpp, nfpp, lnZv


# scenario family -> FULL_SCENARIOS row indices it produces
_FAMILY_ROWS = (("TP", (0,)), ("EB", (1, 2)), ("PTP", (3,)),
                ("PEB", (4, 5)), ("STP", (6,)), ("SEB", (7, 8)),
                ("DTP", (9,)), ("DEB", (10, 11)), ("BTP", (12,)),
                ("BEB", (13, 14)))


@lru_cache(maxsize=128)
def _build_family_step(mesh, fam, cfg):
    """Build + cache ONE scenario family's jitted sharded program: the
    (B,)-per-row lnZ evidences over the ('targets', 'draws') mesh.

    Replaces the round-2 fused 15-scenario megaprogram: per-family
    programs dispatch asynchronously (restoring serial-loop overlap on
    one chip), compile faster, and shard identically. Keys reproduce the
    fused step's stream layout (ks = split(fold_in(key, d_idx), 8), one
    slot per family; nearby slots fold_in(key, 100 + slot))."""
    (N, n_t, ns, chunk, exptime, flatpriors, has_cc, eff_cc_filt,
     use_molusc) = cfg
    N_local = N // mesh.shape["draws"]
    twin_local = max(N_local // eng.TWIN_DIV, 1)

    def per_target(b):
        d_idx = jax.lax.axis_index("draws")
        key = jax.random.fold_in(b["key"], d_idx)
        ks = jax.random.split(key, 8)
        time_i, obs_i, sigma = b["time"], b["obs_dev"], b["sigma"]
        P_orb, M_s, R_s = b["P_orb"], b["M_s"], b["R_s"]
        Teff, plx = b["Teff"], b["plx"]
        seps, cons = b["seps"], b["cons"]
        u1a = jnp.full((N_local,), b["u1"], jnp.float32)
        u2a = jnp.full((N_local,), b["u2"], jnp.float32)
        ones = jnp.ones((N_local,), jnp.float32)
        if use_molusc:
            # per-draw companion mass ratios from the MOLUSC posterior
            # with the reference's zero-padding semantics: P(zero) =
            # 1 - kept/N (ml.py:455-464 pads the kept rows to N)
            r = jax.random.randint(jax.random.fold_in(key, 424242),
                                   (N_local,), 0, N)
            n_q = b["molusc_qs"].shape[0]
            qs0 = jnp.where(r < b["molusc_kept"],
                            b["molusc_qs"][jnp.clip(r, 0, n_q - 1)], 0.0)
        else:
            qs0 = jnp.zeros((N_local,), jnp.float32)
        kw = dict(exptime=exptime, n_t=n_t, ns=ns, chunk=chunk)

        def ev(lnL, lnw, n_total=N):
            m, s = _local_lnZ_parts(lnL + lnw)
            return _combine_lnZ(m, s, n_total, "draws")

        def planet(d, u1x, u2x, g, lnprior, obs=None, sig=None):
            obs = obs_i if obs is None else obs
            sig = sigma if sig is None else sig
            lnL = lnL_planet(time_i, obs, sig, d["k"], d["P"], d["a_R"],
                             d["inc_rad"], d["eccs"], d["w_rad"], u1x, u2x,
                             g, d["mask"], **kw)
            return ev(lnL, lnprior + d["lnw"])

        def eb_pair(d, u1x, u2x, lnprior, obs=None, sig=None):
            obs = obs_i if obs is None else obs
            sig = sigma if sig is None else sig
            lnL = lnL_eb(time_i, obs, sig, d["k"], d["ksec"], d["P"],
                         d["a_R"], d["inc_rad"], d["eccs"], d["w_rad"],
                         u1x, u2x, d["g_pri"], d["g_sec"], d["mask"],
                         apply_veto=True, **kw)
            # twin branch on its own conditioned draw set (engine module
            # notes); the global twin denominator is nt * n_draw_shards
            t = d["twin"]
            nt = t["P"].shape[0]
            u1t = t.get("u1s", u1x[:nt])
            u2t = t.get("u2s", u2x[:nt])
            lnL_t = lnL_eb(time_i, obs, sig, t["k"], t["ksec"],
                           2.0 * t["P"], t["a_R"], t["inc_rad"],
                           t["eccs"], t["w_rad"], u1t, u2t, t["g_pri"],
                           t["g_sec"], t["mask"], apply_veto=False, **kw)
            return (ev(lnL, lnprior + d["lnw"]),
                    ev(lnL_t, t["lnprior"] + t["lnw"],
                       nt * mesh.shape["draws"]))

        if fam == "TP":
            # TP (reference triceratops.py:797)
            d = eng.sample_planet_target(ks[0], P_orb, P_orb, M_s, R_s,
                                         N=N_local, flatpriors=flatpriors)
            return (planet(d, u1a, u2a, ones, 0.0),)
        if fam == "EB":
            # EB, EBx2P (:843)
            d = eng.sample_teb(ks[1], P_orb, P_orb, M_s, R_s, Teff,
                               N=N_local, twin_n=twin_local)
            return eb_pair(d, u1a, u2a, 0.0)
        if fam == "PTP":
            # PTP (:904)
            d = eng.sample_ptp(ks[2], P_orb, P_orb, M_s, R_s, Teff, plx, qs0,
                               seps, cons, N=N_local, flatpriors=flatpriors,
                               use_molusc=use_molusc, cc_filt=eff_cc_filt)
            return (planet(d, u1a, u2a, d["g"], d["lnprior"]),)
        if fam == "PEB":
            # PEB, PEBx2P (:953)
            d = eng.sample_peb(ks[3], P_orb, P_orb, M_s, R_s, Teff, plx, qs0,
                               seps, cons, N=N_local, use_molusc=use_molusc,
                               cc_filt=eff_cc_filt, twin_n=twin_local)
            return eb_pair(d, u1a, u2a, d["lnprior"])
        if fam == "STP":
            # STP (:1017)
            d = eng.sample_stp(ks[4], P_orb, P_orb, M_s, R_s, Teff, plx, qs0,
                               b["u1_tab10"], b["u2_tab10"], seps, cons,
                               N=N_local, flatpriors=flatpriors,
                               use_molusc=use_molusc, cc_filt=eff_cc_filt)
            return (planet(d, d["u1s"], d["u2s"], d["g"], d["lnprior"]),)
        if fam == "SEB":
            # SEB, SEBx2P (:1066)
            d = eng.sample_seb(ks[5], P_orb, P_orb, M_s, R_s, Teff, plx, qs0,
                               b["u1_tab13"], b["u2_tab13"], seps, cons,
                               N=N_local, use_molusc=use_molusc,
                               cc_filt=eff_cc_filt,
                               twin_n=max(N_local // eng.TWIN_DIV_SEB, 1))
            return eb_pair(d, d["u1s"], d["u2s"], d["lnprior"])
        if fam == "DTP":
            # DTP (:1130)
            d = eng.sample_background_planet(
                ks[6], P_orb, P_orb, M_s, R_s, b["bg"], seps, cons,
                N=N_local, flatpriors=flatpriors, has_cc=has_cc,
                host_is_bg=False, n_comp=b["n_comp"])
            return (planet(d, u1a, u2a, d["g"], d["lnprior"]),)
        if fam == "DEB":
            # DEB, DEBx2P (:1178)
            d = eng.sample_background_eb(
                ks[7], P_orb, P_orb, M_s, R_s, Teff, b["bg"], seps, cons,
                N=N_local, has_cc=has_cc, host_is_bg=False,
                cc_filt=eff_cc_filt or "TESS", n_comp=b["n_comp"],
                twin_n=twin_local)
            return eb_pair(d, u1a, u2a, d["lnprior"])
        if fam == "BTP":
            # BTP (:1242)
            d = eng.sample_background_planet(
                jax.random.fold_in(ks[6], 1), P_orb, P_orb, M_s, R_s,
                b["bg"], seps, cons, N=N_local, flatpriors=flatpriors,
                has_cc=has_cc, host_is_bg=True, n_comp=b["n_comp"])
            return (planet(d, d["u1s"], d["u2s"], d["g"], d["lnprior"]),)
        if fam == "BEB":
            # BEB, BEBx2P (:1291)
            d = eng.sample_background_eb(
                jax.random.fold_in(ks[7], 1), P_orb, P_orb, M_s, R_s, Teff,
                b["bg"], seps, cons, N=N_local, has_cc=has_cc,
                host_is_bg=True, cc_filt=eff_cc_filt or "TESS",
                n_comp=b["n_comp"], twin_n=twin_local)
            return eb_pair(d, d["u1s"], d["u2s"], d["lnprior"])

        # nearby-star rows: NTP or NEB/NEBx2P for one slot, on the flux
        # renormalized for that star's aperture contribution
        # (renorm_flux, reference funcs.py:164-177; scenario reuse
        # triceratops.py:1344-1428). Invalid (padding) slots -> -inf.
        fr = b["nb_fluxratio"]
        valid = b["nb_valid"]
        neg = jnp.float32(-jnp.inf)
        obs_k = obs_i / fr
        sig_k = sigma / fr
        nu1 = jnp.full((N_local,), b["nb_u1"], jnp.float32)
        nu2 = jnp.full((N_local,), b["nb_u2"], jnp.float32)
        kA, kB = jax.random.split(
            jax.random.fold_in(key, 100 + b["nb_slot"]))
        if fam == "NTP":
            d = eng.sample_planet_target(kA, P_orb, P_orb, b["nb_M_s"],
                                         b["nb_R_s"], N=N_local,
                                         flatpriors=flatpriors)
            z = planet(d, nu1, nu2, ones, 0.0, obs=obs_k, sig=sig_k)
            return (jnp.where(valid, z, neg),)
        if fam == "NEB":
            d = eng.sample_teb(kB, P_orb, P_orb, b["nb_M_s"], b["nb_R_s"],
                               b["nb_Teff"], N=N_local, twin_n=twin_local)
            z1, z2 = eb_pair(d, nu1, nu2, 0.0, obs=obs_k, sig=sig_k)
            return (jnp.where(valid, z1, neg), jnp.where(valid, z2, neg))
        raise ValueError(f"unknown scenario family {fam!r}")

    fam_rows = dict(_FAMILY_ROWS)
    n_out = len(fam_rows[fam]) if fam in fam_rows else (
        1 if fam == "NTP" else 2)

    @partial(shard_map, mesh=mesh, in_specs=(P("targets"),),
             out_specs=(P("targets"),) * n_out,
             check_vma=False)
    def step(batch_shard):
        return jax.vmap(per_target)(batch_shard)

    return jax.jit(step)
