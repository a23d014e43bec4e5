"""Fast-core accuracy: Chebyshev deficit proxy + per-exposure Kepler vs
the exact per-supersample evaluation."""

import numpy as np
import jax
import jax.numpy as jnp

from triceratops_tpu.ops.occult import occult_quad_deficit
from triceratops_tpu.ops.fastcore import (
    cheb_deficit_coeffs, cheb_deficit_eval,
)
from triceratops_tpu.ops.lightcurve import lnL_planet, lnL_eb


def _f32(a):
    return jnp.asarray(np.asarray(a, np.float32))


class TestChebProxy:
    def test_deficit_accuracy(self):
        rng = np.random.default_rng(0)
        n = 200
        k = 10 ** rng.uniform(-2, 0.3, n)
        u1 = rng.uniform(0, 0.8, n)
        u2 = np.clip(rng.uniform(0, 0.4, n), None, 1.0 - u1)
        coeffs = cheb_deficit_coeffs(_f32(k), _f32(u1), _f32(u2))
        zg = rng.uniform(0, 1, (n, 64)) * (1 + k[:, None]) * 1.05
        D_fast = np.asarray(cheb_deficit_eval(coeffs, _f32(zg)))
        D_exact = np.asarray(occult_quad_deficit(
            _f32(k[:, None]), _f32(zg), _f32(u1[:, None]), _f32(u2[:, None])))
        err = np.abs(D_fast - D_exact)
        # the symmetric-sqrt-map 3-segment scheme is < 3e-7 worst-case in
        # f64 (gated below); this f32 run measures the Clenshaw/kernel
        # rounding floor (~1.5e-6 at p99)
        assert np.quantile(err, 0.99) < 3e-6, \
            f"p99 cheb proxy error {np.quantile(err, 0.99):.2e}"
        assert err.max() < 1e-5, f"max cheb proxy error {err.max():.2e}"

    def test_deficit_accuracy_twin_band_f64(self):
        """Fast-vs-exact deficit gate < 1e-6 over
        k in [0.9, 1.1] (the EBx2P twin regime), in f64 so the algorithmic
        error is measured without the f32 rounding floor. Includes the
        razor band |k-1| ~ 1e-4 where the mirror branch point at
        z = -|1-k| pinches the middle segment."""
        f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
        rng = np.random.default_rng(7)
        k = np.concatenate([
            np.linspace(0.9, 1.1, 41),
            1.0 + np.array([-1e-3, 1e-3, -3e-4, 3e-4, -1e-4, 1e-4, 0.0]),
        ])
        n = len(k)
        # physical quadratic LD: u1 >= 0, u1 + u2 <= 1 (non-negative limb
        # intensity), u1 + 2 u2 >= 0 (monotone profile) — the Claret grids
        # the pipeline looks up all satisfy these
        u1 = rng.uniform(0.0, 0.9, n)
        u2 = np.clip(rng.uniform(-0.2, 0.4, n),
                     -u1 / 2.0, 1.0 - u1)
        coeffs = cheb_deficit_coeffs(f64(k), f64(u1), f64(u2))
        zsplit = np.abs(1.0 - k)[:, None]
        # dense z coverage incl. the contact neighbourhoods
        zg = np.concatenate([
            rng.uniform(0, 1, (n, 48)) * (1 + k[:, None]) * 1.02,
            zsplit + np.linspace(-1, 1, 32)[None, :] * 0.03,
            (1 + k[:, None]) + np.linspace(-1, 0, 16)[None, :] * 0.02,
        ], axis=1)
        zg = np.clip(zg, 0.0, None)
        D_fast = np.asarray(cheb_deficit_eval(coeffs, f64(zg)))
        D_exact = np.asarray(occult_quad_deficit(
            f64(k[:, None]), f64(zg), f64(u1[:, None]), f64(u2[:, None])))
        err = np.abs(D_fast - D_exact)
        assert err.max() < 1e-6, \
            f"twin-band max proxy error {err.max():.2e} at " \
            f"k={k[np.unravel_index(err.argmax(), err.shape)[0]]}"

    def test_out_of_transit_zero(self):
        coeffs = cheb_deficit_coeffs(_f32([0.1]), _f32([0.4]), _f32([0.2]))
        D = np.asarray(cheb_deficit_eval(coeffs, _f32([[1.2, 5.0, 100.0]])))
        assert np.all(np.abs(D) < 1e-6)


class TestTabulatedCoeffs:
    """k-tabulated basis coefficients (coeffs-v2) vs exact-node
    coefficients, over every k-segment of the table (incl. the k = 1
    contact degeneracy and the breakpoints) with PHYSICAL (u1, u2)
    pairs drawn jointly from the bundled LDC grids (independent
    sampling can produce u1 + u2 > 1, i.e. negative limb intensity,
    where the exact path's node-level clip makes the comparison
    meaningless)."""

    def _cases(self, n=1200, seed=3):
        import os
        rng = np.random.default_rng(seed)
        k = np.concatenate([
            10 ** rng.uniform(-3, 0.3, n // 2),
            rng.uniform(0.9, 1.1, n // 4),
            rng.uniform(0.99, 1.01, n // 8),
            rng.uniform(1.1, 2.0, n // 8),
            [1e-3, 2.0, 1.0, 6.0 / 7.0, 299.0 / 300.0, 301.0 / 300.0,
             7.0 / 6.0, 0.999999],
        ])
        grids = np.load(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "triceratops_tpu", "data", "ldc_grids.npz"))
        U1 = np.concatenate([grids["tess_u1"], grids["kepler_u1"]])
        U2 = np.concatenate([grids["tess_u2"], grids["kepler_u2"]])
        idx = rng.integers(0, U1.size, k.size)
        return k, U1[idx], U2[idx]

    def test_tab_matches_exact_f64(self):
        from triceratops_tpu.ops.fastcore import cheb_deficit_coeffs_tab
        k, u1, u2 = self._cases()
        rng = np.random.default_rng(4)
        ce = cheb_deficit_coeffs(jnp.asarray(k), jnp.asarray(u1),
                                 jnp.asarray(u2))
        ct = cheb_deficit_coeffs_tab(jnp.asarray(k), jnp.asarray(u1),
                                     jnp.asarray(u2))
        zg = rng.uniform(0, 1, (k.size, 96)) * (1 + k[:, None])
        De = np.asarray(cheb_deficit_eval(ce, jnp.asarray(zg)))
        Dt = np.asarray(cheb_deficit_eval(ct, jnp.asarray(zg)))
        err = np.abs(De - Dt)
        i = np.unravel_index(err.argmax(), err.shape)
        assert err.max() < 2.5e-7, \
            f"tabulated-coeff deficit error {err.max():.2e} at k={k[i[0]]}"

    def test_tab_matches_exact_f32(self):
        from triceratops_tpu.ops.fastcore import cheb_deficit_coeffs_tab
        k, u1, u2 = self._cases()
        rng = np.random.default_rng(5)
        ce = cheb_deficit_coeffs(jnp.asarray(k), jnp.asarray(u1),
                                 jnp.asarray(u2))       # f64 reference
        ct = cheb_deficit_coeffs_tab(_f32(k), _f32(u1), _f32(u2))
        zg = rng.uniform(0, 1, (k.size, 96)) * (1 + k[:, None])
        De = np.asarray(cheb_deficit_eval(ce, jnp.asarray(zg)))
        Dt = np.asarray(cheb_deficit_eval(ct, _f32(zg)))
        err = np.abs(De - Dt)
        i = np.unravel_index(err.argmax(), err.shape)
        assert err.max() < 3e-6, \
            f"f32 tabulated-coeff deficit error {err.max():.2e} at k={k[i[0]]}"

    def test_dispatcher_routes_by_dtype(self):
        from triceratops_tpu.ops import fastcore as fc
        assert fc.COEFFS_BACKEND == "auto"
        k, u1, u2 = _f32([0.1, 1.0]), _f32([0.3, 0.3]), _f32([0.2, 0.2])
        ct = fc.deficit_coeffs(k, u1, u2)
        cr = fc.cheb_deficit_coeffs_tab(k, u1, u2)
        for a, b in zip(ct, cr):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        k64 = jnp.asarray([0.1, 1.0])
        ce = fc.deficit_coeffs(k64, jnp.asarray([0.3, 0.3]),
                               jnp.asarray([0.2, 0.2]))
        cx = fc.cheb_deficit_coeffs(k64, jnp.asarray([0.3, 0.3]),
                                    jnp.asarray([0.2, 0.2]))
        for a, b in zip(ce, cx):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestFastVsExactCores:
    def _inputs(self, N=3000, n_t=60, seed=1):
        rng = np.random.default_rng(seed)
        time = np.linspace(-0.15, 0.15, n_t).astype(np.float32)
        obs = rng.normal(0, 5e-4, n_t).astype(np.float32)
        k = 10 ** rng.uniform(-2, -0.7, N)
        P = np.full(N, 3.0)
        aR = np.full(N, 9.6)
        # transiting inclinations
        inc = np.arccos(rng.uniform(0, 1, N) * (1 + k) / aR)
        e = rng.uniform(0, 0.5, N)
        w = rng.uniform(-np.pi, np.pi, N)
        u1 = np.full(N, 0.4)
        u2 = np.full(N, 0.2)
        g = np.ones(N)
        m = np.ones(N, bool)
        return (jnp.asarray(time), jnp.asarray(obs), np.float32(5e-4),
                *map(_f32, (k, P, aR, inc, e, w, u1, u2, g)),
                jnp.asarray(m))

    def test_planet_core(self):
        args = self._inputs()
        kw = dict(exptime=0.00139, n_t=60, ns=8, chunk=1024)
        fast = np.asarray(lnL_planet(*args, **kw))
        exact = np.asarray(lnL_planet(*args, **kw, exact=True))
        finite = np.isfinite(exact)
        assert finite.mean() > 0.9
        d = np.abs(fast[finite] - exact[finite])
        # per-draw lnL differences from the ~1e-6-flux proxy error stay
        # well below unit log-evidence scale; unbiased-ness at the lnZ
        # level is gated by TestEndToEndConsistency
        assert np.quantile(d, 0.99) < 0.2, f"p99 lnL diff {np.quantile(d,0.99)}"
        assert d.max() < 2.0, f"max lnL diff {d.max()}"

    def test_eb_core(self):
        (t, obs, sig, k, P, aR, inc, e, w, u1, u2, g, m) = self._inputs()
        k_eb = _f32(np.clip(np.asarray(k) * 8.0, 0.05, 0.98))
        ksec = 1.0 / k_eb
        kw = dict(exptime=0.00139, n_t=60, ns=8, chunk=1024)
        # chi^2 agreement on the twin path (no veto: vetoes with these
        # undiluted test params reject every draw)
        fast = np.asarray(lnL_eb(t, obs, sig, k_eb, ksec, P, aR, inc, e, w,
                                 u1, u2, g, g, m, **kw, apply_veto=False))
        exact = np.asarray(lnL_eb(t, obs, sig, k_eb, ksec, P, aR, inc, e, w,
                                  u1, u2, g, g, m, **kw, apply_veto=False,
                                  exact=True))
        both = np.isfinite(fast) & np.isfinite(exact)
        assert both.mean() > 0.9
        d = np.abs(fast[both] - exact[both])
        # undiluted deep eclipses against a flat curve have |lnL| ~ 1e7;
        # only draws near the likelihood peak carry weight, so require
        # tight *relative* agreement everywhere and tight absolute
        # agreement for the best draws
        rel = d / (np.abs(exact[both]) + 10.0)
        assert np.quantile(rel, 0.99) < 1e-3
        top = np.argsort(-exact[both])[:100]
        assert np.abs((fast[both] - exact[both])[top]).max() < 1.0
        # veto decisions (secondary scan is always exact) must agree
        fast_v = np.asarray(lnL_eb(t, obs, sig, k_eb, ksec, P, aR, inc, e,
                                   w, u1, u2, g, g, m, **kw))
        exact_v = np.asarray(lnL_eb(t, obs, sig, k_eb, ksec, P, aR, inc, e,
                                    w, u1, u2, g, g, m, **kw, exact=True))
        agree = (np.isfinite(fast_v) == np.isfinite(exact_v)).mean()
        assert agree > 0.999, f"veto agreement {agree}"


class TestEndToEndConsistency:
    def test_lnZ_fast_matches_exact(self):
        """Full TTP evidence: fast path vs exact path on identical draws
        must agree far within MC noise."""
        from triceratops_tpu.scenarios import engine as eng
        from triceratops_tpu.core.numerics import log_mean_exp_jax
        from triceratops_tpu.ops.lightcurve import lnL_planet

        N, n_t, ns = 20000, 60, 8
        rng = np.random.default_rng(2)
        time = np.linspace(-0.15, 0.15, n_t).astype(np.float32)
        obs = rng.normal(0, 5e-4, n_t).astype(np.float32)
        d = eng.sample_planet_target(jax.random.key(0), np.float32(3.0),
                                     np.float32(3.0), np.float32(1.0),
                                     np.float32(1.0), N=N, flatpriors=False)
        u1a = _f32(np.full(N, 0.4))
        u2a = _f32(np.full(N, 0.2))
        out = {}
        for exact in (False, True):
            lnL = lnL_planet(jnp.asarray(time), jnp.asarray(obs),
                             np.float32(5e-4), d["k"], d["P"], d["a_R"],
                             d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                             _f32(np.ones(N)), d["mask"],
                             exptime=0.00139, n_t=n_t, ns=ns, chunk=2048,
                             exact=exact)
            out[exact] = float(log_mean_exp_jax(lnL + d["lnw"], N))
        assert abs(out[True] - out[False]) < 0.02, out
