"""Build the k-tabulated Chebyshev basis-coefficient tables for the
deficit proxy (ops/fastcore.cheb_deficit_coeffs_tab).

Background. The fast likelihood core represents the occultation deficit
D(z) per draw as three Chebyshev series (one per z-segment, each under
the symmetric sqrt map — ops/fastcore.py module docstring). The series
coefficients were originally derived per draw from 54 exact kernel node
evaluations (ops/occult.py Green's-theorem kernel) — the most expensive
stage of the core after the Kepler solve. But the DCT is linear and

    D = (c0*A0 + c1*A1 + c2*J) / (pi*omega),

with (c0,c1,c2,omega) functions of (u1,u2) only, so the per-segment
Chebyshev coefficients of the three BASIS integrals A0 (overlap area),
A1 (int sqrt(1-r^2)), J (int r^2) depend only on the radius ratio k.
This script tabulates those 3x18x3 = 162 scalar functions of k as
piecewise Chebyshev series in a mapped k variable, k^2-normalized so
small-k coefficients stay O(1) (D -> k^2 * I(z)/(4 omega') as k -> 0).
At runtime the per-draw stage is then one small matmul
(ops/fastcore.py cheb_deficit_coeffs_tab).

k-segment layout. Breakpoints at 6/7, 1 -/+ 1/300 and 7/6 are the kinks
of the middle-break clip c = clip(6|1-k|, 0.02, (zmax-zsplit)/2); k = 1
is the contact-degeneracy point, approached with sqrt-resolved maps
(coefficient functions carry |1-k|^(1/2)-type behavior there). Measured
worst-case deficit error of the tabulation vs per-draw exact-node
coefficients (f64, over k x z x the LDC-grid (u1,u2) corners incl. the
worst-amplification pair): 7.7e-8 — an order below the 8e-7 proxy
truncation budget (tests/test_fastcore.py gates it).

Output: triceratops_tpu/data/cheb_k_tables.npz
  breaks (9,) f8, kinds (8,) i8 (0 affine, 1 log, 2 sqrt_hi, 3 sqrt_lo),
  degs (8,) i8, C (sum(degs), 162) f8 block-stacked segment-major; the
  162 columns are (z-segment, Chebyshev order, basis) flattened with
  basis order (A0, A1, J).

Usage: python tools/build_cheb_k_tables.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from triceratops_tpu.ops import occult as oc  # noqa: E402
from triceratops_tpu.ops import fastcore as fc  # noqa: E402

M = fc.M_CHEB

BREAKS = np.array([1e-3, 0.05, 0.35, 6.0 / 7.0, 299.0 / 300.0, 1.0,
                   301.0 / 300.0, 7.0 / 6.0, 2.0])
KINDS = np.array([1, 0, 0, 2, 2, 3, 3, 0])   # log, affine, affine, ...
DEGS = np.array([20, 20, 20, 24, 12, 12, 24, 20])

_PROBES = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)]


def _weights(u1, u2):
    om = 1.0 - u1 / 3.0 - u2 / 6.0
    return np.array([1.0 - u1 - 2.0 * u2, u1 + 2.0 * u2, u2]) / om


_PROBE_INV = np.linalg.inv(np.stack([_weights(*p) for p in _PROBES]))


def from_kappa(x, klo, khi, kind):
    t = (x + 1.0) / 2.0
    if kind == 0:
        return klo + (khi - klo) * t
    if kind == 1:
        return np.exp(np.log(klo) + (np.log(khi) - np.log(klo)) * t)
    if kind == 2:                      # sqrt_hi: resolve toward khi
        return khi - (khi - klo) * (1.0 - t) ** 2
    if kind == 3:                      # sqrt_lo: resolve toward klo
        return klo + (khi - klo) * t**2
    raise ValueError(kind)


def basis_coeffs_exact(kvec):
    """(nk, 3 z-seg, M, 3 basis) k^2-normalized basis coefficients."""
    kvec = np.asarray(kvec, float)
    zsplit = np.abs(1.0 - kvec)
    zmax = 1.0 + kvec
    c = np.clip(fc._BREAK_SLOPE * zsplit, fc._BREAK_FLOOR,
                (zmax - zsplit) / 2.0)
    zmid = zsplit + c
    wA = np.maximum(zsplit, 1e-6)
    wB1 = np.maximum(c, 1e-6)
    wB2 = np.maximum(zmax - zmid, 1e-6)
    s = fc._S_NODES[None, :]
    zs = [wA[:, None] * s, zsplit[:, None] + wB1[:, None] * s,
          zmid[:, None] + wB2[:, None] * s]
    out = np.empty((kvec.size, 3, M, 3))
    for gi, z in enumerate(zs):
        probes = []
        for (u1, u2) in _PROBES:
            D = np.asarray(oc.occult_quad_deficit(
                jnp.asarray(kvec)[:, None], jnp.asarray(z),
                jnp.float64(u1), jnp.float64(u2)))
            probes.append(D @ fc._DCT_T)
        out[:, gi] = np.stack(probes, axis=-1) @ _PROBE_INV.T
    return out / (kvec[:, None, None, None] ** 2)


def main():
    blocks = []
    for g in range(8):
        deg = int(DEGS[g])
        nodes = np.cos((np.arange(deg) + 0.5) * np.pi / deg)
        kn = from_kappa(nodes, BREAKS[g], BREAKS[g + 1], int(KINDS[g]))
        vals = basis_coeffs_exact(kn).reshape(deg, -1)   # (deg, 162)
        theta = (np.arange(deg) + 0.5) * np.pi / deg
        Dm = (2.0 / deg) * np.cos(np.outer(np.arange(deg), theta))
        Dm[0] *= 0.5
        blocks.append(Dm @ vals)                         # (deg, 162)
    C = np.concatenate(blocks, axis=0)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "triceratops_tpu", "data", "cheb_k_tables.npz")
    np.savez_compressed(out, breaks=BREAKS, kinds=KINDS, degs=DEGS, C=C)
    print(f"wrote {os.path.normpath(out)}: C {C.shape}, "
          f"{os.path.getsize(os.path.normpath(out))/1024:.0f} KiB")


if __name__ == "__main__":
    main()
