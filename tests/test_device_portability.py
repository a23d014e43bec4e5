"""What keeps the package right on a GPU: compile-cache placement, pinned
f32 contraction precision, imports that need only numpy/scipy/JAX, and
the csv readers that replaced pandas on the compute path."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import triceratops_tpu
from triceratops_tpu.funcs import trilegal_results
from triceratops_tpu.ops import fastcore, lightcurve
from triceratops_tpu.populations.molusc import load_molusc_kept
from triceratops_tpu.populations.synthetic import make_synthetic_trilegal


class TestCompilationCache:
    def test_env_var_set_means_package_sets_nothing(self, tmp_path):
        env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
        assert triceratops_tpu.compilation_cache_dir(env) is None

    def test_default_is_fixed_dir_in_checkout(self):
        d = triceratops_tpu.compilation_cache_dir({})
        root = triceratops_tpu.__file__.rsplit("/", 2)[0]
        assert d == f"{root}/.jax_cache"
        assert triceratops_tpu.compilation_cache_dir({}) == d


def _f32(n, lo=0.0, hi=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(lo, hi, n), jnp.float32)


def _deficit_fast():
    n = 64
    k, u1, u2 = _f32(n, 0.01, 0.2), _f32(n, 0.2, 0.4), _f32(n, 0.1, 0.3)
    P = jnp.full((n,), 3.0, jnp.float32)
    aR = jnp.full((n,), 9.6, jnp.float32)
    inc = jnp.full((n,), 1.55, jnp.float32)
    z = jnp.zeros((n,), jnp.float32)
    t = jnp.linspace(-0.1, 0.1, 16, dtype=jnp.float32)
    return (lambda *a: lightcurve._mean_deficit_fast(t, 0.00139, *a, 16, 20),
            (k, P, aR, inc, z, z, u1, u2))


def _coeffs(fn):
    n = 64
    return fn, (_f32(n, 0.01, 1.5), _f32(n, 0.2, 0.4), _f32(n, 0.1, 0.3))


@pytest.mark.parametrize("case", [
    lambda: _coeffs(fastcore.cheb_deficit_coeffs),
    lambda: _coeffs(fastcore.cheb_deficit_coeffs_tab),
    _deficit_fast,
], ids=["dct_exact_nodes", "tab_basis", "exposure_mean"])
def test_f32_contractions_pin_highest_precision(case):
    """No f32 dot in the deficit stages may run at default precision,
    which a GPU may execute as TF32 (~1e-3 relative): every dot_general
    in the lowered program carries precision HIGHEST."""
    fn, args = case()
    text = jax.jit(fn).lower(*args).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln


@pytest.mark.parametrize("module", ["triceratops_tpu.scenarios.api",
                                    "triceratops_tpu.parallel.sharding"])
def test_compute_path_imports_without_pandas(module):
    code = ("import sys; sys.modules['pandas'] = None; "
            f"import {module}; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         cwd=triceratops_tpu.__file__.rsplit("/", 2)[0])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_trilegal_reader_matches_pandas(tmp_path):
    pd = pytest.importorskip("pandas")
    path = make_synthetic_trilegal(str(tmp_path / "tri.csv"),
                                   Tmag_target=10.0, n_stars=500, seed=3)
    # pandas' default float parser may be one ulp off; csv_floats parses
    # exactly, as pandas does with float_precision="round_trip"
    df = pd.read_csv(path, float_precision="round_trip")[:-2]
    Tmags = df["TESS"].values.astype(float)
    mask = Tmags >= 11.0
    want = (Tmags, df["Mact"].values.astype(float),
            df["logg"].values.astype(float),
            10 ** df["logTe"].values.astype(float),
            np.array(df["[M/H]"], dtype=float), df["J"].values.astype(float),
            df["H"].values.astype(float), df["Ks"].values.astype(float))
    got = trilegal_results(path, 11.0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[mask])


def test_molusc_reader_matches_pandas(tmp_path):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(5)
    path = tmp_path / "molusc.csv"
    pd.DataFrame({
        "mass ratio": rng.uniform(0.01, 0.9, 300),
        "semi-major axis(AU)": rng.uniform(1, 300, 300),
        "eccentricity": rng.uniform(0.0, 0.9, 300),
    }).to_csv(path, index=False)
    df = pd.read_csv(path, float_precision="round_trip")
    a = df["semi-major axis(AU)"].values
    e = df["eccentricity"].values
    want = df[a * (1 - e) > 10]["mass ratio"].values.copy()
    want[want < 0.1 / 1.1] = 0.1 / 1.1
    np.testing.assert_array_equal(load_molusc_kept(str(path), 1.1), want)


@pytest.mark.gpu
def test_f32_core_on_gpu_matches_f64_reference(gpu):
    """The shipped f32 core on the card against the f64 exact path on
    the host CPU, at chip_smoke's gates (a small-draw version of its
    phase 3)."""
    import chip_smoke

    rng = np.random.default_rng(7)
    t = np.linspace(-0.15, 0.15, 100)
    chip_smoke.core_vs_reference("gpu-test", t, rng.normal(0, 4e-4, 100),
                                 4e-4, ns=20, N=4096)
