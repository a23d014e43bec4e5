"""Measure the shipping f32 deficit stack end-to-end (CPU, ~1 min).

Produces the measured row of the f32 error-budget ledger in
docs/parity.md. Run: python bench_scripts/f32_error_stack.py

Stack = cheb_deficit_coeffs_tab (f32, k-tabulated basis + 11-node GL in
the table build) -> cheb_deficit_eval (f32 Clenshaw) vs the f64 exact
occult_quad_deficit (32-node GL) on a dense (k, z, u1, u2) stress grid.
"""
import os
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp

from triceratops_tpu.ops.fastcore import (
    cheb_deficit_coeffs_tab, cheb_deficit_eval)
from triceratops_tpu.ops.occult import occult_quad_deficit

rng = np.random.default_rng(0)
# k stress set: log-uniform + the k~1 twin band + the table kinks
k = np.concatenate([
    10 ** rng.uniform(-2.3, 0.3, 3000),
    rng.uniform(0.9, 1.1, 2000),
    1.0 + rng.uniform(-1/300, 1/300, 1000),
    np.array([6/7, 1 - 1/300, 1 + 1/300, 7/6, 0.01, 1.0, 2.0]),
])
n = k.size
# LDC extremes + interior
u1 = rng.uniform(0.0, 0.8, n)
u2 = rng.uniform(-0.1, 0.4, n)
f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))

ct = cheb_deficit_coeffs_tab(f32(k), f32(u1), f32(u2))
zg = rng.uniform(0, 1, (n, 128)) * (1 + k[:, None])
# include near-contact z rows
zg[:, :4] = np.abs(1 - k[:, None]) + np.array([1e-6, 1e-4, 1e-3, 1e-2])
zg[:, 4:8] = np.minimum(k[:, None], 1.0) * np.array([0.0, 0.3, 0.9, 0.999])
Dt = np.asarray(jax.jit(cheb_deficit_eval)(ct, f32(zg)), np.float64)
De = np.asarray(jax.jit(occult_quad_deficit)(
    jnp.asarray(k)[:, None], jnp.asarray(zg), jnp.asarray(u1)[:, None],
    jnp.asarray(u2)[:, None]))
err = np.abs(De - Dt)
i = np.unravel_index(err.argmax(), err.shape)
print("n draws", n, "max |D_f32stack - D_f64exact| =", err.max(),
      "at k=", k[i[0]], "z=", zg[i], "u1=", u1[i[0]], "u2=", u2[i[0]])
print("p999 =", np.quantile(err, 0.999), "p99 =", np.quantile(err, 0.99))
