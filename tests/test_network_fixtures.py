"""Recorded-fixture tests for the network ladder: TRILEGAL
query/save/parse, SPOC directory scrape and aperture
extraction — all offline, with canned payloads standing in for the live
services (reference funcs.py:241-475).

mechanicalsoup and astropy are not installed in this environment; the
tests stub just those modules (the stubs record what our code sends and
serve canned responses), so what is exercised is THIS package's ladder
logic, form-field constants, URL construction and parsing — not the
third-party libraries.
"""

import sys
import types

import numpy as np
import pandas as pd
import pytest

from triceratops_tpu.funcs import (
    save_trilegal, trilegal_results, find_url, get_aperture,
    query_TRILEGAL, segment_ID,
)


# ---------------------------------------------------------------------------
# TRILEGAL result save/parse
# ---------------------------------------------------------------------------

TRILEGAL_V16_HEADER = (
    "#Gc logAge [M/H] m_ini logL logTe logg m-M0 Av m2/m1 mbol "
    "TESS J H Ks Mact"
)
TRILEGAL_V15_HEADER = (
    "#Gc logAge [M/H] m_ini logL logTe logg m-M0 Av m2/m1 mbol "
    "J H Ks Mact"
)


def _write_trilegal(path, header, rows, terminated=True):
    lines = [header]
    for r in rows:
        lines.append(" ".join(f"{v:.4f}" for v in r))
    if terminated:
        lines.append("#TRILEGAL normally terminated")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _v16_rows(n, Tmag0=12.0):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        logTe = rng.uniform(3.5, 3.9)
        rows.append([1, 9.0, 0.0, 1.0, 0.1, logTe, 4.4, 8.0, 0.1, 0.0,
                     4.7, Tmag0 + i, Tmag0 + i - 0.8, Tmag0 + i - 1.0,
                     Tmag0 + i - 1.1, 0.9])
    return rows


class TestSaveTrilegal:
    def test_unavailable_returns_zero(self, capsys):
        out = save_trilegal(None, 123)
        assert out == 0.0
        assert "Ignoring BTP" in capsys.readouterr().out

    def test_save_and_parse_roundtrip(self, tmp_path, monkeypatch):
        src = _write_trilegal(tmp_path / "result.dat", TRILEGAL_V16_HEADER,
                              _v16_rows(6))
        monkeypatch.chdir(tmp_path)
        fname = save_trilegal(src, 9000)
        assert fname == "9000_TRILEGAL.csv"
        df = pd.read_csv(tmp_path / fname)
        assert "TESS" in df.columns and "Mact" in df.columns
        # parse through the consumer; the termination line occupies the
        # trailing rows that trilegal_results drops ([:-2])
        (Tmags, Masses, loggs, Teffs, Zs, J, H, K) = trilegal_results(
            str(tmp_path / fname), Tmag=11.0)
        assert len(Tmags) >= 4
        assert np.all(Tmags >= 11.0)
        assert np.allclose(Masses, 0.9)
        assert np.allclose(loggs, 4.4)

    def test_poll_until_terminated(self, tmp_path, monkeypatch):
        """The poll loop re-reads the URL until the termination line
        appears (reference funcs.py:323-329)."""
        src = tmp_path / "slow.dat"
        _write_trilegal(src, TRILEGAL_V16_HEADER, _v16_rows(3),
                        terminated=False)
        calls = {"n": 0}

        def fake_sleep(_):
            calls["n"] += 1
            _write_trilegal(src, TRILEGAL_V16_HEADER, _v16_rows(3),
                            terminated=True)

        import time as _time
        monkeypatch.setattr(_time, "sleep", fake_sleep)
        monkeypatch.chdir(tmp_path)
        fname = save_trilegal(str(src), 9001)
        assert fname == "9001_TRILEGAL.csv"
        assert calls["n"] >= 1


class TestTrilegalResultsV15:
    def test_stassun_jk_to_tmag_branches(self, tmp_path):
        """v1.5 output has no TESS column; Tmags come from the Stassun
        et al. 2018 J/Ks polynomials with all four J-Ks branches
        (reference funcs.py:374-393)."""
        # rows with controlled J, Ks per branch; H unused in conversion
        jks = [0.3, 0.85, -0.5, 1.4]          # the four branches
        rows = []
        for i, jk in enumerate(jks):
            J = 12.0 + i
            K = J - jk
            rows.append([1, 9.0, 0.0, 1.0, 0.1, 3.7, 4.4, 8.0, 0.1, 0.0,
                         4.7, J, J - 0.4, K, 0.8])
        src = _write_trilegal(tmp_path / "v15.dat", TRILEGAL_V15_HEADER,
                              rows + rows[:2])  # padding rows (dropped)
        df = pd.read_csv(src, sep=r"\s+")
        df.to_csv(tmp_path / "v15.csv")
        (Tmags, *_rest) = trilegal_results(str(tmp_path / "v15.csv"),
                                           Tmag=0.0)

        def stassun(J, jk):
            if -0.1 <= jk <= 0.7:
                return (J + 1.22163 * jk**3 - 1.74299 * jk**2
                        + 1.89115 * jk + 0.0563)
            if 0.7 < jk <= 1.0:
                return (J - 269.372 * jk**3 + 668.453 * jk**2
                        - 545.64 * jk + 147.811)
            if jk < -0.1:
                return J + 0.5
            return J + 1.75

        expected = [stassun(12.0 + i, jk) for i, jk in enumerate(jks)]
        assert np.allclose(sorted(Tmags[:4]), sorted(expected), atol=1e-6)


# ---------------------------------------------------------------------------
# TRILEGAL form-submit ladder (stubbed mechanicalsoup)
# ---------------------------------------------------------------------------

class _FakePage:
    def __init__(self, hrefs):
        self._hrefs = hrefs

    def select(self, sel):
        assert sel == "a"
        return [types.SimpleNamespace(get=lambda k, h=h: h)
                for h in self._hrefs]


class _FakeBrowser:
    """Stands in for mechanicalsoup.StatefulBrowser: records the form
    fields our code sets and serves canned per-URL link lists."""

    pages = {}          # url -> list of hrefs
    submissions = []    # (url, dict of fields)

    def __init__(self):
        self._fields = {}
        self._url = None
        self.session = types.SimpleNamespace(verify=True)

    def open(self, url):
        self._url = url

    def select_form(self, nr):
        assert nr == 0

    def __setitem__(self, k, v):
        self._fields[k] = v

    def submit_selected(self):
        _FakeBrowser.submissions.append((self._url, dict(self._fields)))

    def get_current_page(self):
        return _FakePage(_FakeBrowser.pages.get(self._url, []))


@pytest.fixture()
def fake_mechanicalsoup(monkeypatch):
    mod = types.ModuleType("mechanicalsoup")
    mod.StatefulBrowser = _FakeBrowser
    monkeypatch.setitem(sys.modules, "mechanicalsoup", mod)
    import time as _time
    monkeypatch.setattr(_time, "sleep", lambda s: None)
    _FakeBrowser.pages = {}
    _FakeBrowser.submissions = []
    return _FakeBrowser


V16_URL = "http://stev.oapd.inaf.it/cgi-bin/trilegal_1.6"
V15_URL = "http://stev.oapd.inaf.it/cgi-bin/trilegal_1.5"


class TestQueryTrilegalLadder:
    def test_v16_success(self, fake_mechanicalsoup):
        fake_mechanicalsoup.pages[V16_URL] = ["../tmp/output123.dat"]
        out = query_TRILEGAL(54.8, -42.7, verbose=0)
        assert out == "http://stev.oapd.inaf.it/tmp/output123.dat"
        (url, fields), = fake_mechanicalsoup.submissions
        assert url == V16_URL
        assert fields["gal_coord"] == "2"
        assert fields["eq_alpha"] == "54.8"
        assert fields["eq_delta"] == "-42.7"
        assert fields["field"] == "0.1"
        assert fields["photsys_file"] == "tab_mag_odfnew/tab_mag_TESS_2mass.dat"
        assert fields["mag_lim"] == "21"
        assert fields["binary_kind"] == "0"

    def test_v16_to_v15_fallback(self, fake_mechanicalsoup):
        fake_mechanicalsoup.pages[V16_URL] = []       # v1.6 busy
        fake_mechanicalsoup.pages[V15_URL] = ["../tmp/out15.dat"]
        out = query_TRILEGAL(54.8, -42.7, verbose=0)
        assert out == "http://stev.oapd.inaf.it/tmp/out15.dat"
        urls = [u for u, _ in fake_mechanicalsoup.submissions]
        assert urls == [V16_URL, V15_URL]
        # the v1.5 form uses the 2MASS-only photometric system
        assert (fake_mechanicalsoup.submissions[1][1]["photsys_file"]
                == "tab_mag_odfnew/tab_mag_2mass.dat")

    def test_both_busy_returns_none(self, fake_mechanicalsoup, capsys):
        fake_mechanicalsoup.pages[V16_URL] = []
        fake_mechanicalsoup.pages[V15_URL] = []
        out = query_TRILEGAL(54.8, -42.7, verbose=0)
        assert out is None
        assert "too busy" in capsys.readouterr().out

    def test_missing_mechanicalsoup_degrades(self, monkeypatch, capsys):
        monkeypatch.setitem(sys.modules, "mechanicalsoup", None)
        out = query_TRILEGAL(54.8, -42.7)
        assert out is None
        assert "mechanicalsoup not available" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# SPOC aperture: directory scrape + FITS bitmap (stubbed I/O)
# ---------------------------------------------------------------------------

DIR_HTML = b"""<html><body><pre>
<a href="?sort=N">Name</a>
<a href="tess2018206045859-s0001-0000000300038935-0120-s_lc.fits">lc</a>
<a href="tess2018206045859-s0001-0000000300038935-0120-s_tp.fits">tp</a>
</pre></body></html>"""


class TestFindUrl:
    def test_zero_padded_path_and_lc_selection(self, monkeypatch):
        import urllib.request as _ur

        seen = {}

        def fake_urlopen(url):
            seen["url"] = url
            return types.SimpleNamespace(read=lambda: DIR_HTML)

        monkeypatch.setattr(_ur, "urlopen", fake_urlopen)
        url = find_url(300038935, sector=1)
        base = ("https://archive.stsci.edu/missions/tess/tid/"
                "s0001/0000/0003/0003/8935/")
        assert seen["url"] == base
        assert url == base + ("tess2018206045859-s0001-0000000300038935"
                              "-0120-s_lc.fits")

    def test_segment_id_padding(self):
        assert segment_ID("42") == "0042"
        assert segment_ID("12345") == "12345"


class _FakeHDU:
    def __init__(self, data=None, header=None):
        self.data = data
        self.header = header or {}


class _FakeHDUList(list):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class TestGetAperture:
    def test_bitmap_max_pixels_with_crval_offsets(self, monkeypatch):
        """HDU 2's aperture bitmap: max-valued pixels + CRVAL1P/2P
        offsets, returned (col, row)-flipped (reference funcs.py:467-473)."""
        bitmap = np.array([
            [0, 1, 1, 0],
            [1, 3, 3, 1],
            [1, 3, 3, 1],
            [0, 1, 1, 0],
        ])
        hdus = _FakeHDUList([
            _FakeHDU(), _FakeHDU(),
            _FakeHDU(data=bitmap, header={"CRVAL1P": 100, "CRVAL2P": 200}),
        ])
        fits_mod = types.ModuleType("astropy.io.fits")
        fits_mod.open = lambda f, mode="readonly": hdus
        io_mod = types.ModuleType("astropy.io")
        io_mod.fits = fits_mod
        astropy_mod = types.ModuleType("astropy")
        astropy_mod.io = io_mod
        monkeypatch.setitem(sys.modules, "astropy", astropy_mod)
        monkeypatch.setitem(sys.modules, "astropy.io", io_mod)
        monkeypatch.setitem(sys.modules, "astropy.io.fits", fits_mod)
        import triceratops_tpu.funcs as funcs
        monkeypatch.setattr(funcs, "find_url", lambda ID, s: "/fake.fits")

        ap = get_aperture(300038935, 1)
        # max value 3 at rows/cols {1,2}x{1,2}; +CRVAL2P on rows,
        # +CRVAL1P on cols; flipped to (col, row)
        expect = {(101, 201), (102, 201), (101, 202), (102, 202)}
        assert {tuple(p) for p in ap} == expect
