"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from triceratops_tpu.parallel.sharding import (
    make_mesh, batch_fpp_tp_eb, batch_fpp_full, prepare_target_batch,
    FULL_SCENARIOS)


def _batch_inputs(B, n_t=24, ns=2, seed=0):
    rng = np.random.default_rng(seed)
    time = np.linspace(-0.15, 0.15, n_t)
    t_ss = jnp.asarray(np.tile(time.astype(np.float32), (B, 1)))
    obs_dev = jnp.asarray(rng.normal(0, 5e-4, (B, n_t)).astype(np.float32))
    keys = jax.random.split(jax.random.key(0), B)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    scal = dict(
        sigmas=f32(np.full(B, 5e-4)), P_orbs=f32(np.full(B, 3.0)),
        M_ss=f32(np.full(B, 1.0)), R_ss=f32(np.full(B, 1.0)),
        Teffs=f32(np.full(B, 5800.0)), u1s=f32(np.full(B, 0.4)),
        u2s=f32(np.full(B, 0.2)))
    return keys, t_ss, obs_dev, scal, n_t, ns


class TestDryrun:
    def test_graft_entry(self):
        from __graft_entry__ import entry, dryrun_multichip
        fn, args = entry()
        out = np.asarray(fn(*args))
        assert out.shape == (8192,)
        assert np.all(np.isfinite(out) | (out == -np.inf))
        dryrun_multichip(8)


class TestShardingInvariance:
    def test_mesh_shapes(self):
        mesh = make_mesh(8, n_target_shards=2)
        assert dict(mesh.shape) == {"targets": 2, "draws": 4}

    def test_draw_sharding_consistent_estimate(self):
        """The same workload on 1x8 and 2x4 meshes must give FPPs that
        agree to MC noise (the draws differ by key folding, not the
        estimator)."""
        B = 4
        keys, t_ss, obs_dev, scal, n_t, ns = _batch_inputs(B)
        N = 8 * 4096
        out = {}
        for nts in (1, 2):
            mesh = make_mesh(8, n_target_shards=nts)
            fpp, lnZ = batch_fpp_tp_eb(mesh, keys, t_ss, obs_dev,
                                       scal["sigmas"], scal["P_orbs"],
                                       scal["M_ss"], scal["R_ss"],
                                       scal["Teffs"], scal["u1s"],
                                       scal["u2s"], N=N, n_t=n_t, ns=ns,
                                       chunk=512)
            out[nts] = (np.asarray(fpp), np.asarray(lnZ))
            assert np.all(np.isfinite(out[nts][1]))
        # different draw partitions -> statistically compatible evidences
        d = np.abs(out[1][1] - out[2][1])
        assert np.all(d < 1.5), f"lnZ mismatch across meshes: {d}"


def _transit_lc(n_t=40, seed=3, P=3.0, rp_re=3.0, sigma=5e-4):
    from triceratops_tpu.ops.occult import occult_quad_deficit
    from triceratops_tpu.core.kepler import projected_z
    from triceratops_tpu.constants import G, MSUN, RSUN, REARTH

    rng = np.random.default_rng(seed)
    time = np.linspace(-0.15, 0.15, n_t)
    a = ((G * MSUN) / (4 * np.pi**2) * (P * 86400) ** 2) ** (1 / 3)
    z, front = projected_z(jnp.asarray(time), 0.0, P, a / RSUN,
                           np.deg2rad(89.5), 0.0, 0.0)
    D = np.asarray(occult_quad_deficit(
        jnp.asarray(rp_re * REARTH / RSUN), z, jnp.asarray(0.4),
        jnp.asarray(0.2))) * np.asarray(front)
    return time, 1.0 - D + rng.normal(0, sigma, n_t), sigma, P


@pytest.fixture(scope="module")
def full_batch_inputs(tmp_path_factory):
    from triceratops_tpu.populations.synthetic import make_synthetic_trilegal

    trilegal = make_synthetic_trilegal(
        str(tmp_path_factory.mktemp("shard") / "trilegal.csv"),
        Tmag_target=10.0, seed=1)
    time, flux, sigma, P = _transit_lc()
    targets = [dict(time=time, flux=flux, sigma=sigma, P_orb=P, M_s=1.0,
                    R_s=1.0, Teff=5800.0, Z=0.0, plx=10.0, Tmag=10.0,
                    Jmag=9.3, Hmag=9.1, Kmag=9.0, trilegal_fname=trilegal,
                    key=jax.random.key(11 + i)) for i in range(4)]
    batch, n_t, has_cc = prepare_target_batch(targets)
    return targets, batch, n_t, has_cc, trilegal


class TestFullFPPSharded:
    def test_mesh_invariance(self, full_batch_inputs):
        """1x8, 2x4 and 4x2 meshes give statistically compatible per-
        scenario evidences (the draws differ by key folding only)."""
        _, batch, n_t, has_cc, _ = full_batch_inputs
        N = 8 * 4096
        out = {}
        for nts in (1, 4):
            mesh = make_mesh(8, n_target_shards=nts)
            fpp, _nfpp, lnZ = batch_fpp_full(mesh, batch, N=N, n_t=n_t,
                                             ns=2, chunk=1024,
                                             has_cc=has_cc)
            out[nts] = (np.asarray(fpp), np.asarray(lnZ))
            assert np.all(np.isfinite(out[nts][1]))
            assert np.all((out[nts][0] >= 0) & (out[nts][0] <= 1))
        twin = np.array([s.endswith("x2P") for s in FULL_SCENARIOS])
        seb = np.array([s == "SEBx2P" for s in FULL_SCENARIOS])
        a, b = out[1][1], out[4][1]
        d = np.abs(a - b)
        # Per-row rule: agree within the gate OR sit > 5 nats below the
        # winner in BOTH runs. Deep-losing EB-family rows are
        # extreme-order needle statistics — a rare draw hitting the
        # needle moves lnZ by several nats (measured up to ~5 at this
        # fixture, docs/parity.md) while the row's probability weight
        # e^-depth stays < e^-5 = 0.7%, far inside the 0.08 FPP gate;
        # gating their lnZ would gate pure noise. Rows that matter
        # (depth <= 5) are broad-likelihood regimes where the measured
        # key-to-key sd is <= 0.26 (twins; 0.8 for the bimodal-needle
        # SEBx2P), so 2.0 / 3.0 sit at > 3.5 sigma (was 8 nats with
        # shared draws, 4 early r3; non-twin gate 1.5).
        gate = np.where(seb, 3.0, np.where(twin, 2.0, 1.5))
        deep = (a < a.max(1, keepdims=True) - 5.0) \
            & (b < b.max(1, keepdims=True) - 5.0)
        assert np.all((d < gate) | deep), (d, deep)
        assert np.all(np.abs(out[1][0] - out[4][0]) < 0.08)

    def test_matches_single_device_api(self, full_batch_inputs):
        """Sharded full-FPP == the product lnZ_* path within MC noise.
        Non-twin scenarios agree to ~0.4 nats at N=64k (measured); twins
        are max-dominated and looser."""
        targets, batch, n_t, has_cc, trilegal = full_batch_inputs
        from triceratops_tpu.scenarios import api
        from triceratops_tpu.core.numerics import normalize_probabilities

        N = 8 * 8192
        mesh = make_mesh(8, n_target_shards=1)
        fpp, _nfpp, lnZ = batch_fpp_full(mesh, batch, N=N, n_t=n_t, ns=2,
                                         chunk=1024, has_cc=has_cc)
        lnZ = np.asarray(lnZ)[0]
        fpp = float(np.asarray(fpp)[0])

        t = targets[0]
        common = (t["time"], np.asarray(t["flux"]), t["sigma"], t["P_orb"],
                  t["M_s"], t["R_s"], t["Teff"], t["Z"])
        kw = dict(N=N, nsamples=2, key=jax.random.key(99))
        bg = (t["Tmag"], t["Jmag"], t["Hmag"], t["Kmag"], trilegal)
        r_tp = api.lnZ_TTP(*common, **kw)
        r_eb = api.lnZ_TEB(*common, **kw)
        r_ptp = api.lnZ_PTP(*common, t["plx"], **kw)
        r_peb = api.lnZ_PEB(*common, t["plx"], **kw)
        r_stp = api.lnZ_STP(*common, t["plx"], **kw)
        r_seb = api.lnZ_SEB(*common, t["plx"], **kw)
        r_dtp = api.lnZ_DTP(*common, *bg, **kw)
        r_deb = api.lnZ_DEB(*common, *bg, **kw)
        nc = (t["time"], np.asarray(t["flux"]), t["sigma"], t["P_orb"],
              t["M_s"], t["R_s"], t["Teff"])
        r_btp = api.lnZ_BTP(*nc, *bg, **kw)
        r_beb = api.lnZ_BEB(*nc, *bg, **kw)
        api_lnZ = np.array([
            float(r_tp["lnZ"]), float(r_eb[0]["lnZ"]), float(r_eb[1]["lnZ"]),
            float(r_ptp["lnZ"]), float(r_peb[0]["lnZ"]),
            float(r_peb[1]["lnZ"]), float(r_stp["lnZ"]),
            float(r_seb[0]["lnZ"]), float(r_seb[1]["lnZ"]),
            float(r_dtp["lnZ"]), float(r_deb[0]["lnZ"]),
            float(r_deb[1]["lnZ"]), float(r_btp["lnZ"]),
            float(r_beb[0]["lnZ"]), float(r_beb[1]["lnZ"])])
        probs, _ = normalize_probabilities(api_lnZ)
        fpp_api = 1.0 - (probs[0] + probs[3] + probs[9])

        d = np.abs(lnZ - api_lnZ)
        twin = np.array([s.endswith("x2P") for s in FULL_SCENARIOS])
        seb = np.array([s == "SEBx2P" for s in FULL_SCENARIOS])
        # Per-row rule as in test_mesh_invariance: agree within the
        # gate OR sit > 5 nats below the winner in both runs (needle
        # order statistics with probability weight < e^-5 — lnZ noise
        # there cannot move FPP). Twin gates tightened 8 -> 4 -> 2 nats
        # (3 for the bimodal-needle SEBx2P) by the conditioned +
        # LHS-stratified twin draw sets (docs/parity.md).
        gate = np.where(seb, 3.0, np.where(twin, 2.0, 1.2))
        deep = (lnZ < lnZ.max() - 5.0) & (api_lnZ < api_lnZ.max() - 5.0)
        diag = dict(zip(FULL_SCENARIOS, np.round(lnZ - api_lnZ, 3)))
        assert np.all((d < gate) | deep), diag
        assert abs(fpp - fpp_api) < 0.05, (fpp, fpp_api)


class TestNearbyStarsSharded:
    def test_nearby_rows_and_nfpp(self, full_batch_inputs):
        """A batch target with a nearby star grows 3 lnZ rows and a
        nonzero NFPP; parity vs the frontend's NTP/NEB rows (same
        renormalized flux, same scenario reuse,
        reference triceratops.py:1344-1428)."""
        targets, _, n_t, _, trilegal = full_batch_inputs
        from triceratops_tpu.scenarios import api

        t0 = dict(targets[0])
        t0["nearby"] = [dict(mass=0.8, rad=0.8, Teff=5000.0, Z=0.0,
                             fluxratio=0.01, tdepth=0.5)]
        batch, n_t_b, has_cc = prepare_target_batch([t0, dict(targets[1])])
        mesh = make_mesh(8, n_target_shards=1)
        N = 8 * 4096
        fpp, nfpp, lnZ = batch_fpp_full(mesh, batch, N=N, n_t=n_t, ns=2,
                                        chunk=1024, has_cc=has_cc)
        fpp = np.asarray(fpp)
        nfpp = np.asarray(nfpp)
        lnZ = np.asarray(lnZ)
        assert lnZ.shape == (2, 18)
        # target 2 has no nearby star -> padded slot at -inf, NFPP 0
        assert np.all(np.isinf(lnZ[1, 15:])) and lnZ[1, 15:].max() < 0
        assert nfpp[1] == 0.0
        assert np.all(np.isfinite(lnZ[0, 15:]))
        assert 0.0 <= nfpp[0] <= 1.0

        # parity of the NTP row against the api on the renormalized flux
        fr = 0.01
        flux = np.asarray(t0["flux"])
        renormed = (flux - (1 - fr)) / fr
        r_ntp = api.lnZ_TTP(t0["time"], renormed, t0["sigma"] / fr,
                            t0["P_orb"], 0.8, 0.8, 5000.0, 0.0, N=N,
                            nsamples=2, key=jax.random.key(5))
        assert abs(lnZ[0, 15] - float(r_ntp["lnZ"])) < 1.5, \
            (lnZ[0, 15], float(r_ntp["lnZ"]))


def test_drop_scenario_sharded(full_batch_inputs):
    """drop_scenario entries get lnZ = -inf without being computed
    (reference triceratops.py:784-789 semantics)."""
    _, batch, n_t, has_cc, _ = full_batch_inputs
    mesh = make_mesh(8, n_target_shards=1)
    N = 8 * 2048
    drop = ("EB", "EBx2P", "PEB", "PEBx2P", "SEB", "SEBx2P",
            "DEB", "DEBx2P", "BEB", "BEBx2P")
    fpp, nfpp, lnZ = batch_fpp_full(mesh, batch, N=N, n_t=n_t, ns=2,
                                    chunk=1024, has_cc=has_cc,
                                    drop_scenario=drop)
    lnZ = np.asarray(lnZ)
    dropped = [i for i, s in enumerate(FULL_SCENARIOS) if s in drop]
    kept = [i for i in range(15) if i not in dropped]
    assert np.all(np.isneginf(lnZ[:, dropped]))
    assert np.all(np.isfinite(lnZ[:, kept]))
    assert np.all((np.asarray(fpp) >= 0) & (np.asarray(fpp) <= 1))


class TestMoluscSharded:
    def test_molusc_batch_matches_api(self, full_batch_inputs, tmp_path):
        """batch_fpp_full with per-target molusc_file: the P*/S* rows use
        the ingested posterior (lnprior = 0, kept/N weighting) and agree
        with the single-device api path within MC noise."""
        import pandas as pd
        from triceratops_tpu.scenarios import api

        targets, _, n_t, _, trilegal = full_batch_inputs
        rng = np.random.default_rng(5)
        n_keep = 200
        mfile = str(tmp_path / "molusc.csv")
        pd.DataFrame({
            "mass ratio": rng.uniform(0.2, 0.9, n_keep),
            "semi-major axis(AU)": rng.uniform(50, 300, n_keep),
            "eccentricity": rng.uniform(0.0, 0.5, n_keep),
        }).to_csv(mfile, index=False)
        tgts = [dict(t, molusc_file=mfile) for t in targets[:2]]
        batch, n_t_b, has_cc = prepare_target_batch(tgts)
        assert "molusc_qs" in batch
        mesh = make_mesh(8, n_target_shards=1)
        N = 8 * 8192
        fpp, _n, lnZ = batch_fpp_full(mesh, batch, N=N, n_t=n_t, ns=2,
                                      chunk=1024, has_cc=has_cc)
        lnZ = np.asarray(lnZ)
        assert np.all(np.isfinite(lnZ[:, :15]) | (lnZ[:, :15] < 0))

        t = tgts[0]
        r_ptp = api.lnZ_PTP(t["time"], np.asarray(t["flux"]), t["sigma"],
                            t["P_orb"], t["M_s"], t["R_s"], t["Teff"],
                            t["Z"], t["plx"], N=N, nsamples=2,
                            molusc_file=mfile, key=jax.random.key(3))
        i_ptp = FULL_SCENARIOS.index("PTP")
        assert abs(lnZ[0, i_ptp] - float(r_ptp["lnZ"])) < 1.5, \
            (lnZ[0, i_ptp], float(r_ptp["lnZ"]))

    def test_mixed_molusc_batch_rejected(self, full_batch_inputs, tmp_path):
        import pandas as pd
        targets, _, _, _, _ = full_batch_inputs
        mfile = str(tmp_path / "m1.csv")
        pd.DataFrame({"mass ratio": [0.5],
                      "semi-major axis(AU)": [100.0],
                      "eccentricity": [0.1]}).to_csv(mfile, index=False)
        tgts = [dict(targets[0], molusc_file=mfile), dict(targets[1])]
        with pytest.raises(ValueError, match="batch-wide"):
            prepare_target_batch(tgts)


def test_drop_scenario_rejects_nearby_rows(full_batch_inputs):
    """Nearby-star rows cannot be dropped; asking must fail loudly, not
    silently no-op (ADVICE round-2 item 3)."""
    _, batch, n_t, has_cc, _ = full_batch_inputs
    mesh = make_mesh(8, n_target_shards=1)
    with pytest.raises(ValueError, match="nearby-star"):
        batch_fpp_full(mesh, batch, N=8 * 2048, n_t=n_t, ns=2, chunk=1024,
                       has_cc=has_cc, drop_scenario=("NEB",))
    with pytest.raises(ValueError, match="unknown"):
        batch_fpp_full(mesh, batch, N=8 * 2048, n_t=n_t, ns=2, chunk=1024,
                       has_cc=has_cc, drop_scenario=("NOPE",))
