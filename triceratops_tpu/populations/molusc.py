"""MOLUSC companion-posterior ingestion.

External binary-population posterior replacing the analytic
``sample_q_companion`` draw in P*/S* scenarios (reference:
marginal_likelihoods.py:455-464): keep rows with periastron
a(1-e) > 10 AU, floor mass ratios at 0.1/M_s, zero-pad to N (padded
entries are excluded by the qs_comp != 0 masks but still count in the MC
denominator, so kept/N carries the companion-frequency weight).
"""

from __future__ import annotations

import numpy as np

from ..funcs import csv_floats, read_csv_columns


def load_molusc_kept(molusc_file: str, M_s: float) -> np.ndarray:
    """Surviving companion mass ratios (un-padded), with the reference's
    periastron cut and mass-ratio floor (ml.py:455-464)."""
    df = read_csv_columns(molusc_file)
    a = csv_floats(df["semi-major axis(AU)"])
    e = csv_floats(df["eccentricity"])
    q = csv_floats(df["mass ratio"])[a * (1 - e) > 10]
    q[q < 0.1 / M_s] = 0.1 / M_s
    return q


def load_molusc_qs(molusc_file: str, M_s: float, N: int) -> np.ndarray:
    q = load_molusc_kept(molusc_file, M_s)
    if len(q) > N:
        raise ValueError(
            f"MOLUSC file keeps {len(q)} rows > N={N} draws; increase N "
            "(the reference zero-pads the kept rows to N)")
    return np.pad(q, (0, N - len(q)))
