"""Host-side astro utilities and external-data I/O.

API-parity module mirroring the reference's ``triceratops.funcs``
(reference: triceratops/funcs.py): stellar relations, flux relations,
flux renormalization, contrast-curve I/O, TRILEGAL query/parse, SPOC
aperture fetch. Network-dependent functions degrade gracefully when their
optional dependencies (mechanicalsoup, astropy, bs4) are absent.
"""

from __future__ import annotations

import csv

import numpy as np

from .constants import G, MSUN, RSUN, REARTH, AU, PI  # noqa: F401 (re-export)
from .populations.stellar import stellar_relations, flux_relation  # noqa: F401


def color_Teff_relations(V, Ks):
    """V-Ks -> Teff (reference funcs.py:143-161; unused in main path)."""
    if V - Ks < 5.05:
        theta = 0.54042 + 0.23676 * (V - Ks) - 0.00796 * (V - Ks) ** 2
        return 5040 / theta
    theta = (-0.4809 + 0.8009 * (V - Ks) - 0.1039 * (V - Ks) ** 2
             + 0.0056 * (V - Ks) ** 3)
    return 5040 / theta + 205.26


def renorm_flux(flux, flux_err, star_fluxratio: float):
    """Renormalize light curve for nearby-star flux contamination
    (reference funcs.py:164-177)."""
    renormed_flux = (flux - (1 - star_fluxratio)) / star_fluxratio
    renormed_flux_err = flux_err / star_fluxratio
    return renormed_flux, renormed_flux_err


def Gauss2D(x, y, mu_x, mu_y, sigma, A):
    """Circular Gaussian PSF (kept for back-compat; reference
    funcs.py:180-200)."""
    if np.ndim(x) == 0 and np.ndim(y) == 0:
        expo = ((float(x) - mu_x) ** 2 + (float(y) - mu_y) ** 2) / (2 * sigma**2)
        return float(A / (2 * np.pi * sigma**2) * np.exp(-expo))
    xg, yg = np.meshgrid(x, y)
    expo = ((xg - mu_x) ** 2 + (yg - mu_y) ** 2) / (2 * sigma**2)
    return A / (2 * np.pi * sigma**2) * np.exp(-expo)


def file_to_contrast_curve(contrast_curve_file: str):
    """(separations [arcsec], |Delta_mag|) from a 2-column csv
    (reference funcs.py:203-219)."""
    data = np.loadtxt(contrast_curve_file, delimiter=",")
    return data.T[0], np.abs(data.T[1])


def read_csv_columns(path: str, drop_last: int = 0) -> dict:
    """Columns of a headed csv as string arrays, keyed by header name,
    without the last ``drop_last`` data rows. Rows shorter than the
    header are padded with empty strings."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:len(rows) - drop_last]
    n = len(header)
    body = [r + [""] * (n - len(r)) for r in body]
    cols = np.array(body, dtype=str).reshape(len(body), n)
    return {name: cols[:, j] for j, name in enumerate(header)}


def csv_floats(col) -> np.ndarray:
    """A csv string column as float64 (empty fields -> NaN)."""
    return np.array([float(v) if v.strip() else np.nan for v in col])


def separation_at_contrast(delta_mags, separations, contrasts):
    """Limiting separation at contrast via np.interp (reference
    funcs.py:222-238)."""
    return np.interp(delta_mags, contrasts, separations)


# ---------------------------------------------------------------------------
# TRILEGAL galactic-population service
# ---------------------------------------------------------------------------

def query_TRILEGAL(RA: float, Dec: float, verbose: int = 1,
                   verify_ssl: bool = True):
    """Submit the TRILEGAL v1.6 web form (v1.5 fallback); returns the
    result URL or None (reference funcs.py:241-304). Requires
    mechanicalsoup; returns None with a notice when unavailable."""
    try:
        from mechanicalsoup import StatefulBrowser
    except ImportError:
        print("mechanicalsoup not available; TRILEGAL query skipped "
              "(B*/D* scenarios will be ignored unless a trilegal_fname "
              "is provided).")
        return None
    import ssl
    from time import sleep

    def _submit(url, photsys):
        browser = StatefulBrowser()
        if verify_ssl is False:
            ssl._create_default_https_context = ssl._create_unverified_context
            browser.session.verify = False
        browser.open(url)
        browser.select_form(nr=0)
        browser["gal_coord"] = "2"
        browser["eq_alpha"] = str(RA)
        browser["eq_delta"] = str(Dec)
        browser["field"] = "0.1"
        browser["photsys_file"] = photsys
        browser["icm_lim"] = "1"
        browser["mag_lim"] = "21"
        browser["binary_kind"] = "0"
        browser.submit_selected()
        if verbose == 1:
            print("TRILEGAL form submitted.")
        sleep(5)
        page = browser.get_current_page()
        links = page.select("a")
        if len(links) == 0:
            return None
        return "http://stev.oapd.inaf.it/" + links[0].get("href")[3:]

    out = _submit("http://stev.oapd.inaf.it/cgi-bin/trilegal_1.6",
                  "tab_mag_odfnew/tab_mag_TESS_2mass.dat")
    if out is not None:
        return out
    out = _submit("http://stev.oapd.inaf.it/cgi-bin/trilegal_1.5",
                  "tab_mag_odfnew/tab_mag_2mass.dat")
    if out is None:
        print("TRILEGAL too busy, using saved stellar populations instead.")
    return out


def save_trilegal(output_url, ID):
    """Poll the TRILEGAL result URL until done, save to csv; returns the
    filename, or 0.0 when the query was unavailable (reference
    funcs.py:307-333)."""
    from time import sleep
    from pandas import read_csv

    if output_url is None:
        print("Could not access TRILEGAL. Ignoring BTP, BEB, BEBx2P, DTP, "
              "DEB, and DEBx2P scenarios.")
        return 0.0
    for _ in range(1000):
        last = read_csv(output_url, header=None)[-1:]
        if last.values[0, 0] == "#TRILEGAL normally terminated":
            break
        print("...")
        sleep(10)
    df = read_csv(output_url, sep=r"\s+")
    fname = str(ID) + "_TRILEGAL.csv"
    df.to_csv(fname)
    return fname


def trilegal_results(trilegal_fname: str, Tmag: float):
    """Parse a saved TRILEGAL csv: stars fainter than the target, with
    Tmags computed from J/Ks (Stassun et al. 2018 relations) when the
    TESS column is absent (reference funcs.py:335-403)."""
    df = read_csv_columns(trilegal_fname, drop_last=2)
    Masses = csv_floats(df["Mact"])
    loggs = csv_floats(df["logg"])
    Teffs = 10 ** csv_floats(df["logTe"])
    Zs = csv_floats(df["[M/H]"])
    Jmags = csv_floats(df["J"])
    Hmags = csv_floats(df["H"])
    Kmags = csv_floats(df["Ks"])
    if "TESS" in df:
        Tmags = csv_floats(df["TESS"])
    else:
        jk = Jmags - Kmags
        Tmags = np.where(
            (jk >= -0.1) & (jk <= 0.7),
            Jmags + 1.22163 * jk**3 - 1.74299 * jk**2 + 1.89115 * jk + 0.0563,
            np.where((jk > 0.7) & (jk <= 1.0),
                     Jmags - 269.372 * jk**3 + 668.453 * jk**2
                     - 545.64 * jk + 147.811,
                     np.where(jk < -0.1, Jmags + 0.5, Jmags + 1.75)))
    mask = Tmags >= Tmag
    return (Tmags[mask], Masses[mask], loggs[mask], Teffs[mask], Zs[mask],
            Jmags[mask], Hmags[mask], Kmags[mask])


# ---------------------------------------------------------------------------
# SPOC aperture fetch
# ---------------------------------------------------------------------------

def segment_ID(str_segment):
    """Zero-pad a TIC-ID segment to 4 chars (reference funcs.py:405-419)."""
    return str_segment.zfill(4)


def find_url(ID: str, sector: int):
    """Directory-scrape archive.stsci.edu for the sector's s_lc.fits URL
    (reference funcs.py:422-453)."""
    from urllib.request import urlopen
    from bs4 import BeautifulSoup

    url = "https://archive.stsci.edu/missions/tess/tid/"
    str1 = "s" + str(sector).zfill(4)
    s = str(ID)
    padded = s.zfill(16)
    url += "/".join([str1, padded[0:4], padded[4:8], padded[8:12],
                     padded[12:16]]) + "/"
    soup = BeautifulSoup(urlopen(url).read().decode("utf-8"), "html.parser")
    for link in soup.find_all("a"):
        if link.get("href")[-9:] == "s_lc.fits":
            url += link.get("href")
    return url


def get_aperture(ID, sector):
    """SPOC aperture pixels for a sector from the lc FITS HDU 2 bitmap
    (reference funcs.py:455-475). Requires astropy."""
    from astropy.io import fits

    fits_file = find_url(ID, sector)
    with fits.open(fits_file, mode="readonly") as hdulist:
        aperture = hdulist[2].data
        ap_pixels = np.argwhere(aperture == np.max(aperture))
        ap_pixels[:, 0] += hdulist[2].header["CRVAL2P"]
        ap_pixels[:, 1] += hdulist[2].header["CRVAL1P"]
    return np.flip(ap_pixels, axis=1)
