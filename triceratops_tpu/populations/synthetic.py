"""Physically consistent synthetic TRILEGAL-style populations.

For offline tests, benchmarks, and examples a stand-in for the TRILEGAL
galactic-population service is needed. The stars must lie on the same
mass -> (radius, Teff, flux) relations the scenario models assume
(populations/stellar.py): with uncorrelated random (mass, logg, Teff)
triples, the background-host scenarios (BTP/BEB) gain access to
unphysical stars whose transit shapes can absorb systematic data-model
residuals and spuriously dominate the evidence in ultra-low-noise
regimes (see docs/parity.md).

Columns mirror a ``save_trilegal`` csv (funcs.py:307-333) so
``trilegal_results`` parses it unchanged.
"""

from __future__ import annotations

import csv

import numpy as np

from ..constants import G, MSUN, RSUN
from .stellar import stellar_relations, flux_relation

# Sun's apparent TESS magnitude at 10 pc ~ absolute magnitude anchor
_M_SUN_T = 4.63


def make_synthetic_trilegal(path, Tmag_target: float = 10.0,
                            n_stars: int = 3000, seed: int = 0,
                            mag_limit: float = 21.0) -> str:
    """Write a synthetic background population csv; returns the path.

    Masses follow a rough log-uniform IMF over [0.1, 1.6] Msun; radii and
    Teffs come from the framework's stellar relations; loggs are derived
    (log g = log10 GM/R^2); apparent magnitudes combine the mass-flux
    relation with a volume-weighted distance modulus, keeping stars
    fainter than the target (trilegal_results applies the same cut,
    funcs.py:365)."""
    rng = np.random.default_rng(seed)
    n = int(n_stars * 2.5)
    mass = 10 ** rng.uniform(np.log10(0.1), np.log10(1.6), n)
    radius, teff = stellar_relations(mass, np.full(n, np.inf),
                                     np.full(n, np.inf))
    logg = np.log10(G * mass * MSUN / (radius * RSUN) ** 2)
    mh = np.clip(rng.normal(-0.1, 0.25, n), -1.0, 0.4)

    # absolute magnitudes from the band flux relations (vs ~1 Msun)
    def absmag(filt):
        return _M_SUN_T - 2.5 * np.log10(flux_relation(mass, filt))

    M_T = absmag("TESS")
    M_J = absmag("J")
    M_H = absmag("H")
    M_K = absmag("K")
    # volume-weighted distance modulus in [6, 16]
    u = rng.uniform(0, 1, n)
    mu = (6 ** 3 + u * (16 ** 3 - 6 ** 3)) ** (1 / 3)
    tmag = M_T + mu
    keep = (tmag >= Tmag_target) & (tmag <= mag_limit)
    idx = np.flatnonzero(keep)[:n_stars]
    if idx.size < n_stars:  # top up with faint stars if the cut was harsh
        extra = np.flatnonzero(~keep)[: n_stars - idx.size]
        idx = np.concatenate([idx, extra])
    m = len(idx) + 2  # +2 rows dropped by the parser (termination banner)
    sel = np.concatenate([idx, idx[:2]])
    cols = {
        "Gc": np.ones(m, int),
        "logAge": np.full(m, 9.3),
        "[M/H]": mh[sel],
        "m_ini": mass[sel],
        "Mact": mass[sel],
        "logL": np.log10(np.maximum(flux_relation(mass[sel]), 1e-6)),
        "logTe": np.log10(teff[sel]),
        "logg": logg[sel],
        "m-M0": mu[sel],
        "Av": np.zeros(m),
        "TESS": (M_T + mu)[sel],
        "J": (M_J + mu)[sel],
        "H": (M_H + mu)[sel],
        "Ks": (M_K + mu)[sel],
    }
    # the layout of a pandas to_csv with its index column
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + list(cols))
        for i, row in enumerate(zip(*(c.tolist() for c in cols.values()))):
            w.writerow([i, *map(repr, row)])
    return str(path)
