"""Published FPP catalog accessors (ground truth for batch replay).

Tidy versions of the result tables from the two TRICERATOPS papers,
packaged by tools/build_result_tables.py
(reference data: table_data/tab4.txt, tab5.txt, tab7.txt):

* ``classified_tois()`` — tab4: FPP/NFPP for 213 TFOP-classified TOIs at
  2-min and 30-min cadence.
* ``unclassified_tois()`` — tab5: 424 unclassified TOIs.
* ``vetting_catalog()`` — tab7: 384 TOIs with FPP/NFPP and the paper's
  classification (Likely Planet / Likely NFP / ...).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import pandas as pd

_DATA = Path(__file__).resolve().parent.parent / "data"


@lru_cache(maxsize=None)
def _load(name: str) -> pd.DataFrame:
    import pandas as pd

    return pd.read_parquet(_DATA / f"catalog_{name}.parquet")


def classified_tois() -> pd.DataFrame:
    return _load("tab4").copy()


def unclassified_tois() -> pd.DataFrame:
    return _load("tab5").copy()


def vetting_catalog() -> pd.DataFrame:
    return _load("tab7").copy()
