"""Kepler solver and projected-separation checks."""

import numpy as np
import jax.numpy as jnp

from triceratops_tpu.core.kepler import (
    solve_kepler, solve_kepler_sc, projected_z, mean_anomaly_at_transit,
    z2_taylor, E_MAX,
)


class TestSolveKepler:
    def test_residual_over_range(self):
        rng = np.random.default_rng(0)
        M = rng.uniform(-20, 20, 5000)
        e = rng.uniform(0, 0.99, 5000)
        E = np.asarray(solve_kepler(jnp.asarray(M), jnp.asarray(e)))
        ec = np.clip(e, 0, E_MAX)
        resid = E - ec * np.sin(E) - M
        assert np.abs(resid).max() < 1e-10

    def test_f32_path_matches_f64(self):
        """The float32 device path (Markley cubic starter + one staged
        Householder-4 correction) must reach f32 round-off against the
        8-iteration f64 Newton solve, including unwrapped multi-period M
        and the e -> E_MAX edge."""
        rng = np.random.default_rng(1)
        M = rng.uniform(-40, 40, 20000)
        e = np.concatenate([rng.uniform(0, E_MAX, 10000),
                            np.full(10000, E_MAX)])
        Mf = M.astype(np.float32)
        ef = e.astype(np.float32)
        # compare against the f64 solve of the f32-rounded inputs: this
        # isolates solver error from the unavoidable f32 input rounding
        # (wrapping M ~ 40 to a ~1e-3 pericenter anomaly loses ~2e-6
        # absolute regardless of solver)
        Ed = np.asarray(solve_kepler(jnp.asarray(Mf, jnp.float64),
                                     jnp.asarray(ef, jnp.float64)))
        Ef = np.asarray(solve_kepler(jnp.asarray(Mf), jnp.asarray(ef)))
        assert np.abs(Ef.astype(np.float64) - Ed).max() < 2e-5

    def test_circular(self):
        M = np.linspace(-3, 3, 100)
        E = np.asarray(solve_kepler(jnp.asarray(M), jnp.zeros(100)))
        np.testing.assert_allclose(E, M, atol=1e-12)

    def test_f32_returned_sincos_contract(self):
        """The quantities the hot path actually consumes are the RETURNED
        (sinE, cosE), not sin/cos of the unwrapped E (the module's
        'callers must use the returned pair' contract). Gate them
        directly at 1.5e-6 against the f64 solve over a stress grid that
        includes the high-e near-pericenter band."""
        rng = np.random.default_rng(9)
        n = 500000
        M = rng.uniform(-40, 40, n)
        e = np.concatenate([
            rng.uniform(0.0, E_MAX, n // 2),
            rng.uniform(0.9, E_MAX, n // 4),          # high-e band
            np.full(n - n // 2 - n // 4, E_MAX)])     # clamp edge
        # near-pericenter wrapped anomalies for the high-e half
        M[n // 2:] = rng.uniform(-0.3, 0.3, n - n // 2) \
            + 2 * np.pi * np.round(M[n // 2:] / (2 * np.pi))
        Mf = M.astype(np.float32)
        ef = e.astype(np.float32)
        _, s64, c64 = solve_kepler_sc(jnp.asarray(Mf, jnp.float64),
                                      jnp.asarray(ef, jnp.float64))
        _, s32, c32 = solve_kepler_sc(jnp.asarray(Mf), jnp.asarray(ef))
        ds = np.abs(np.asarray(s32, np.float64) - np.asarray(s64))
        dc = np.abs(np.asarray(c32, np.float64) - np.asarray(c64))
        assert ds.max() < 1.5e-6, ds.max()
        assert dc.max() < 1.5e-6, dc.max()


class TestProjectedZ:
    def test_transit_center_is_impact_parameter(self):
        # at t = t0 the separation equals b = a_R * cos(i) * r/a
        a_R, inc = 10.0, np.deg2rad(88.0)
        for e, w in [(0.0, 0.3), (0.3, 1.0), (0.6, -2.0)]:
            z, front = projected_z(jnp.asarray([0.0]), 0.0, 3.0, a_R, inc, e, w)
            # nu_tc = pi/2 - w -> r/a = (1-e^2)/(1 + e sin w)
            r_a = (1 - e**2) / (1 + e * np.sin(w))
            expected = a_R * r_a * abs(np.cos(inc))
            assert front[0]
            np.testing.assert_allclose(float(z[0]), expected, rtol=1e-6)

    def test_behind_star_flagged(self):
        # half a period later the planet is on the far side
        z, front = projected_z(jnp.asarray([1.5]), 0.0, 3.0, 10.0,
                               np.deg2rad(90.0), 0.0, 0.5)
        assert not bool(front[0])

    def test_symmetry_circular(self):
        t = jnp.asarray([-0.02, 0.02])
        z, _ = projected_z(t, 0.0, 3.0, 10.0, np.deg2rad(89.0), 0.0, 0.7)
        np.testing.assert_allclose(float(z[0]), float(z[1]), rtol=1e-6)


class TestF32NearTransitPrecision:
    """Regression: the quadrature form cwnu^2 + cos^2(i) swnu^2 must keep
    the f32 in-transit z to ~1e-6 absolute. The old 1 - sin^2(i) sin^2(w+nu)
    form cancels catastrophically near mid-transit (su -> 1) and was
    measured at 4.7e-4 max z error on these draws."""

    def _draws(self):
        rng = np.random.default_rng(7)
        n = 4000
        P = rng.uniform(1.0, 20.0, n)
        a_R = rng.uniform(3.0, 50.0, n)
        # near-central geometries: b in [0, 1] so cos(i) is small and the
        # old subtraction form operated deep in its cancellation regime
        inc = np.arccos(rng.uniform(0.0, 1.0, n) / a_R)
        e = rng.uniform(0.0, 0.9, n)
        w = rng.uniform(-np.pi, np.pi, n)
        # times within +/- 1.5 transit durations of mid-transit
        dur = P / np.pi / a_R
        t = rng.uniform(-1.5, 1.5, n) * dur
        return t, P, a_R, inc, e, w

    def test_projected_z_f32_matches_f64(self):
        t, P, a_R, inc, e, w = self._draws()
        z64, _ = projected_z(jnp.asarray(t), 0.0, jnp.asarray(P),
                             jnp.asarray(a_R), jnp.asarray(inc),
                             jnp.asarray(e), jnp.asarray(w))
        f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
        z32, _ = projected_z(f32(t), np.float32(0.0), f32(P), f32(a_R),
                             f32(inc), f32(e), f32(w))
        err = np.abs(np.asarray(z32, np.float64) - np.asarray(z64))
        in_transit = np.asarray(z64) < 2.0
        assert err[in_transit].max() < 1e-4, err[in_transit].max()

    def test_z2_taylor_f32_matches_f64(self):
        t, P, a_R, inc, e, w = self._draws()
        z2_64, _, _, _ = z2_taylor(jnp.asarray(t), 0.0, jnp.asarray(P),
                                   jnp.asarray(a_R), jnp.asarray(inc),
                                   jnp.asarray(e), jnp.asarray(w))
        f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))
        z2_32, _, _, _ = z2_taylor(f32(t), np.float32(0.0), f32(P), f32(a_R),
                                   f32(inc), f32(e), f32(w))
        z64 = np.sqrt(np.asarray(z2_64))
        z32 = np.sqrt(np.maximum(np.asarray(z2_32, np.float64), 0.0))
        err = np.abs(z32 - z64)
        in_transit = z64 < 2.0
        assert err[in_transit].max() < 1e-4, err[in_transit].max()


class TestZ2Taylor:
    def test_derivatives_match_numerical(self):
        """Closed-form dz^2/dt and d2z^2/dt2 against high-order central
        differences of projected_z^2 (f64)."""
        rng = np.random.default_rng(3)
        n = 2000
        t = jnp.asarray(rng.uniform(-0.2, 0.2, n))
        P = jnp.asarray(rng.uniform(1.0, 20.0, n))
        a_R = jnp.asarray(rng.uniform(3.0, 50.0, n))
        inc = jnp.asarray(np.arccos(rng.uniform(0, 0.2, n)))
        e = jnp.asarray(rng.uniform(0.0, 0.9, n))
        w = jnp.asarray(rng.uniform(-np.pi, np.pi, n))
        z2, dz2, d2z2, front = z2_taylor(t, 0.0, P, a_R, inc, e, w)

        h = 1e-4
        def z2_at(dt):
            z, _ = projected_z(t + dt, 0.0, P, a_R, inc, e, w)
            return np.asarray(z, np.float64) ** 2
        f0, fp, fm = z2_at(0.0), z2_at(h), z2_at(-h)
        fp2, fm2 = z2_at(2 * h), z2_at(-2 * h)
        num1 = (8 * (fp - fm) - (fp2 - fm2)) / (12 * h)
        num2 = (-fp2 + 16 * fp - 30 * f0 + 16 * fm - fm2) / (12 * h * h)
        scale1 = np.abs(num1).max()
        scale2 = np.abs(num2).max()
        assert np.isclose(np.asarray(z2), f0, rtol=1e-9, atol=1e-9).all()
        assert np.abs(np.asarray(dz2) - num1).max() < 1e-6 * scale1
        assert np.abs(np.asarray(d2z2) - num2).max() < 1e-5 * scale2
        zf, frontf = projected_z(t, 0.0, P, a_R, inc, e, w)
        np.testing.assert_array_equal(np.asarray(front), np.asarray(frontf))
