"""Offline tests for the FITS/aperture/cutout behaviors that normally
need the network: get_spoc_apertures
success/failure, plot_field rendering, and the Kepler/K2 TPF padding
math in _fetch_cutouts (reference triceratops.py:148-226, :337-356).

astropy and lightkurve are absent here; minimal stubs serve canned
cutouts so the package's own padding/offset/WCS-composition logic is
what gets exercised.
"""

import sys
import types

import numpy as np
import pandas as pd
import pytest

import matplotlib
matplotlib.use("Agg")

from triceratops_tpu import target as target_mod
from triceratops_tpu.frontend import target as target_impl


def _stars(n=2):
    rows = []
    for i in range(n):
        rows.append(dict(ID=str(100 + i), Tmag=10.0 + 3 * i, Jmag=9.3,
                         Hmag=9.1, Kmag=9.0, ra=90.0 + i * 1e-3,
                         dec=-60.0 - i * 1e-3, mass=1.0, rad=1.0,
                         Teff=5800.0, plx=10.0,
                         **{"sep (arcsec)": 4.0 * i, "PA (E of N)": 30.0}))
    return pd.DataFrame(rows)


class TestGetSpocApertures:
    def test_returns_one_aperture_per_sector(self, monkeypatch):
        t = target_mod.from_stars(_stars(), sectors=[3, 4])
        canned = {3: np.array([[5, 6], [5, 7]]), 4: np.array([[8, 9]])}
        monkeypatch.setattr(target_impl, "get_aperture",
                            lambda ID, s: canned[s])
        aps = t.get_spoc_apertures()
        assert len(aps) == 2
        assert np.array_equal(aps[0], canned[3])
        assert np.array_equal(aps[1], canned[4])

    def test_failure_prints_and_degrades(self, monkeypatch, capsys):
        t = target_mod.from_stars(_stars(), sectors=[3, 4])

        def boom(ID, s):
            raise OSError("archive unreachable")

        monkeypatch.setattr(target_impl, "get_aperture", boom)
        aps = t.get_spoc_apertures()
        assert aps == []
        assert "No SPOC apertures available." in capsys.readouterr().out


class TestPlotField:
    def test_writes_pdf_offline(self, tmp_path, monkeypatch):
        t = target_mod.from_stars(_stars(3), sectors=[1])
        monkeypatch.chdir(tmp_path)
        t.plot_field(sector=1, save=True, fname=str(tmp_path / "field"))
        out = tmp_path / "field.pdf"
        assert out.exists() and out.stat().st_size > 1000

    def test_with_aperture_overlay(self, tmp_path):
        t = target_mod.from_stars(_stars(3), sectors=[1])
        ap = np.array([[10, 10], [10, 11], [11, 10], [11, 11]])
        t.plot_field(sector=1, ap_pixels=ap, save=True,
                     fname=str(tmp_path / "field_ap"))
        assert (tmp_path / "field_ap.pdf").stat().st_size > 1000


# ---------------------------------------------------------------------------
# Kepler/K2 TPF cutout padding (stubbed lightkurve + astropy)
# ---------------------------------------------------------------------------

class _FakeWCS:
    """all_world2pix returns a fixed per-star pixel position."""

    def __init__(self, header):
        pass

    def all_world2pix(self, ra, dec, origin):
        # deterministic mapping so the test can predict the composition
        return [np.array((ra - 90.0) * 1000.0 + 2.0),
                np.array((dec + 60.0) * 1000.0 + 3.0)]


def _fake_tpf(shape, col0, row0, fail=False):
    flux = np.ones((5,) + shape, dtype=float)  # 5 cadences

    class _HDU1:
        data = {"FLUX": flux}
        header = {"1CRV4P": col0, "2CRV4P": row0}

    class _HDU2:
        header = {}

    class _TPF:
        hdu = [None, _HDU1, _HDU2]

    class _Result:
        def download_all(self, download_dir=None):
            if fail:
                raise OSError("no TPF for this quarter")
            return [_TPF()]

    return _Result()


@pytest.fixture()
def fake_stack(monkeypatch):
    calls = {}

    lk = types.ModuleType("lightkurve")

    def search_targetpixelfile(name, mission=None, **kw):
        calls["name"] = name
        calls["mission"] = mission
        calls.update(kw)
        sector = kw.get("quarter", kw.get("campaign"))
        if sector == 7:
            return _fake_tpf((6, 4), col0=50, row0=70)
        return _fake_tpf((6, 4), 0, 0, fail=True)

    lk.search_targetpixelfile = search_targetpixelfile
    lk.search_tesscut = lambda **kw: None
    monkeypatch.setitem(sys.modules, "lightkurve", lk)

    wcs_mod = types.ModuleType("astropy.wcs")
    wcs_mod.WCS = _FakeWCS
    coords_mod = types.ModuleType("astropy.coordinates")
    coords_mod.SkyCoord = lambda ra, dec, unit=None: (ra, dec)
    units_mod = types.ModuleType("astropy.units")
    astropy_mod = types.ModuleType("astropy")
    astropy_mod.wcs = wcs_mod
    astropy_mod.coordinates = coords_mod
    astropy_mod.units = units_mod
    for name, mod in [("astropy", astropy_mod), ("astropy.wcs", wcs_mod),
                      ("astropy.coordinates", coords_mod),
                      ("astropy.units", units_mod)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return calls


class TestKeplerTpfPadding:
    def test_padding_offsets_and_wcs_composition(self, fake_stack):
        """A (6, 4) Kepler TPF padded into the 22x22 frame: NaN padding
        split evenly, col0/row0 shifted by the leading pad, and star
        pixel coords composed as origin + WCS + pad
        (reference triceratops.py:174-205)."""
        t = target_mod.from_stars(_stars(), sectors=[7], mission="Kepler")
        t.ID = 4914423
        t._fetch_cutouts(t.stars, None)

        assert fake_stack["name"] == "KIC 4914423"
        assert fake_stack["mission"] == "Kepler"
        assert fake_stack["quarter"] == 7

        assert len(t.TESS_images) == 1
        img = t.TESS_images[0]
        assert img.shape == (22, 22)
        # (22-6)//2 = 8 rows before, (22-4)//2 = 9 cols before
        nrb, ncb = 8, 9
        assert np.all(np.isnan(img[:nrb, :]))
        assert np.all(np.isnan(img[:, :ncb]))
        assert np.all(img[nrb:nrb + 6, ncb:ncb + 4] == 1.0)
        assert t.col0s[0] == 50 - ncb
        assert t.row0s[0] == 70 - nrb
        # star 0 at (ra, dec) = (90, -60): WCS gives (2, 3); coords are
        # (col0 + RApix + ncb, row0 + Decpix + nrb) = (50-9+2+9, 70-8+3+8)
        assert t.pix_coords[0][0, 0] == pytest.approx(52.0)
        assert t.pix_coords[0][0, 1] == pytest.approx(73.0)

    def test_failed_sector_skipped(self, fake_stack, capsys):
        """A sector whose download raises is logged and dropped
        (reference triceratops.py:213-216)."""
        t = target_mod.from_stars(_stars(), sectors=[7, 9],
                                  mission="Kepler")
        t.ID = 4914423
        t._fetch_cutouts(t.stars, None)
        out = capsys.readouterr().out
        assert "Sector 9 raised exception" in out
        assert len(t.TESS_images) == 1
        assert len(t.pix_coords) == 1


class TestK2TpfPadding:
    def test_k2_uses_campaign_and_epic_prefix(self, fake_stack):
        """K2 searches 'EPIC <ID>' with campaign= (not quarter=)
        (reference triceratops.py:174-194)."""
        t = target_mod.from_stars(_stars(), sectors=[7], mission="K2")
        t.ID = 201367065
        t._fetch_cutouts(t.stars, None)
        assert fake_stack["name"] == "EPIC 201367065"
        assert fake_stack["mission"] == "K2"
        assert fake_stack["campaign"] == 7
        assert "quarter" not in fake_stack
        assert len(t.TESS_images) == 1
        assert t.TESS_images[0].shape == (22, 22)
