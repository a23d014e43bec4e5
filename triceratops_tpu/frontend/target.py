"""The ``target`` user-facing class: field bookkeeping + orchestration.

API-compatible with the reference's ``triceratops.triceratops.target``
(reference: triceratops/triceratops.py:41-1638): TIC field query, star
edits, PSF dilution depths, scenario orchestration into FPP/NFPP, and
plots. Network services (MAST/TessCut/Vizier) are optional imports; the
``from_stars`` constructor builds a target fully offline from a prepared
stars table, which is also how the test-suite and benchmark fixtures run.
"""

from __future__ import annotations

import warnings
from typing import TYPE_CHECKING

import numpy as np
from scipy.special import ndtr

import jax
import jax.numpy as jnp

from ..constants import PI
from ..core.numerics import normalize_probabilities
from ..funcs import renorm_flux, save_trilegal, query_TRILEGAL, get_aperture
from ..scenarios import api as sc

if TYPE_CHECKING:
    from pandas import DataFrame

_RES_FIELDS = ["M_s", "R_s", "u1", "u2", "P_orb", "inc", "b", "R_p", "ecc",
               "argp", "M_EB", "R_EB", "fluxratio_EB", "fluxratio_comp"]


@jax.jit
def _stack_firsts(leaves):
    """First element of every result leaf, stacked into one vector so a
    full calc_probs run needs a single device->host transfer (see the
    deferred-materialization loop in calc_probs)."""
    return jnp.stack(
        [jnp.ravel(jnp.asarray(a, jnp.float32))[0] for a in leaves])


class target:
    def __init__(self, ID: int, sectors, search_radius: int = 10,
                 mission: str = "TESS", lightkurve_cache_dir=None,
                 trilegal_fname=None, ra: float = None, dec: float = None,
                 verify_ssl: bool = True):
        """Query TIC for nearby sources and FFI cutouts per sector
        (reference triceratops.py:42-263). Requires the optional network
        stack (astroquery + lightkurve + astropy); use ``target.from_stars``
        for offline construction."""
        if mission not in ("TESS", "Kepler", "K2"):
            raise ValueError("Introduced invalid mission: " + mission)
        try:
            import lightkurve  # noqa: F401
            from astroquery.mast import Catalogs
            from astropy.coordinates import SkyCoord
            from astropy.wcs import WCS
            import astropy.units as u
        except ImportError as e:
            raise ImportError(
                "Online target construction needs lightkurve/astroquery/"
                "astropy. Build offline with target.from_stars(...) instead."
            ) from e

        self.ID = ID
        self.mission = mission
        self.sectors = sectors
        self.search_radius = search_radius
        self.N_pix = 2 * search_radius + 2
        pixel_size = (20.25 if mission == "TESS" else 4.0) * u.arcsec

        if mission == "TESS":
            ticid = ID
        else:
            from astroquery.vizier import Vizier
            if ra is None or dec is None:
                if mission == "Kepler":
                    result = (Vizier(columns=["_RA", "_DE"])
                              .query_constraints(KIC=str(ID),
                                                 catalog="J/ApJS/229/30/catalog")[0]
                              .as_array())
                    ra, dec = result[0]["_RA"], result[0]["_DE"]
                else:
                    result = (Vizier(columns=["RAJ2000", "DEJ2000"])
                              .query_constraints(ID=str(ID),
                                                 catalog="IV/34/epic")[0]
                              .as_array())
                    ra, dec = result[0]["RAJ2000"], result[0]["DEJ2000"]
            ticid = Catalogs.query_region(
                SkyCoord(ra, dec, unit="deg"), radius=search_radius * pixel_size,
                catalog="TIC")[0]["ID"]
        df = Catalogs.query_object("TIC" + str(ticid),
                                   radius=search_radius * pixel_size,
                                   catalog="TIC")
        stars = df["ID", "Tmag", "Jmag", "Hmag", "Kmag", "ra", "dec", "mass",
                   "rad", "Teff", "plx", "disposition",
                   "duplicate_id"].to_pandas()

        if trilegal_fname is None:
            self.trilegal_url = query_TRILEGAL(
                stars["ra"].values[0], stars["dec"].values[0], verbose=0,
                verify_ssl=verify_ssl)
            self.trilegal_fname = None
        else:
            self.trilegal_fname = trilegal_fname
            self.trilegal_url = None

        self._fetch_cutouts(stars, lightkurve_cache_dir)
        self._finish_init(stars)

    # ------------------------------------------------------------------
    @classmethod
    def from_stars(cls, stars: DataFrame, ID: int = 0, sectors=(1,),
                   mission: str = "TESS", search_radius: int = 10,
                   pix_coords=None, trilegal_fname=None):
        """Offline constructor from a prepared stars table.

        ``stars`` must provide the reference's TIC columns: ID, Tmag,
        Jmag, Hmag, Kmag, ra, dec, mass, rad, Teff, plx. ``pix_coords``
        is a list (one per sector) of (n_stars, 2) pixel coordinates; a
        single centered grid is synthesized when omitted."""
        if mission not in ("TESS", "Kepler", "K2"):
            raise ValueError("Introduced invalid mission: " + mission)
        self = cls.__new__(cls)
        self.ID = ID
        self.mission = mission
        self.sectors = np.atleast_1d(sectors)
        self.search_radius = search_radius
        self.N_pix = 2 * search_radius + 2
        self.stars = stars.reset_index(drop=True).copy()
        self.trilegal_fname = trilegal_fname
        self.trilegal_url = None
        n = len(stars)
        if pix_coords is None:
            center = self.N_pix / 2.0
            pc = np.full((n, 2), center)
            if {"sep (arcsec)", "PA (E of N)"} <= set(stars.columns):
                px = 20.25 if mission == "TESS" else 4.0
                sep_pix = stars["sep (arcsec)"].values / px
                pa = np.deg2rad(stars["PA (E of N)"].values)
                off = np.c_[sep_pix * np.sin(pa), sep_pix * np.cos(pa)]
                # PA is undefined (NaN) for the target row itself
                # (sep = 0); treat non-finite offsets as on-center.
                pc = pc + np.where(np.isfinite(off), off, 0.0)
            pix_coords = [pc for _ in self.sectors]
        self.pix_coords = [np.asarray(p, dtype=float) for p in pix_coords]
        self.TESS_images = [np.zeros((self.N_pix, self.N_pix))
                            for _ in self.sectors]
        self.col0s = [0 for _ in self.sectors]
        self.row0s = [0 for _ in self.sectors]
        return self

    # ------------------------------------------------------------------
    def _fetch_cutouts(self, stars, lightkurve_cache_dir):
        """Per-sector FFI cutouts + WCS star pixel coordinates with the
        reference's skip-on-failure behavior (triceratops.py:148-226)."""
        import traceback
        import lightkurve
        from astropy.coordinates import SkyCoord
        from astropy.wcs import WCS

        TESS_images, col0s, row0s, pix_coords = [], [], [], []
        ra = stars["ra"].values
        dec = stars["dec"].values
        cutout_coord = SkyCoord(ra[0], dec[0], unit="deg")
        for sector in self.sectors:
            try:
                if self.mission == "TESS":
                    print(f"Getting TessCut for sector {sector}")
                    cuts = lightkurve.search_tesscut(
                        target=cutout_coord, sector=sector).download_all(
                        cutout_size=(self.N_pix, self.N_pix))
                    hdu = cuts[0].hdu
                    wcs = WCS(hdu[2].header)
                    TESS_images.append(np.nanmean(hdu[1].data["FLUX"], axis=0))
                    col0 = hdu[1].header["1CRV4P"]
                    row0 = hdu[1].header["2CRV4P"]
                    nrb = ncb = 0
                else:
                    print(f"Getting TPF for sector {sector}")
                    prefix = "KIC " if self.mission == "Kepler" else "EPIC "
                    kw = ({"quarter": sector} if self.mission == "Kepler"
                          else {"campaign": sector})
                    tpf = lightkurve.search_targetpixelfile(
                        prefix + str(self.ID), mission=self.mission,
                        **kw).download_all(download_dir=lightkurve_cache_dir)
                    hdu = tpf[0].hdu
                    wcs = WCS(hdu[2].header)
                    image = np.nanmean(hdu[1].data["FLUX"], axis=0)
                    nrb = (self.N_pix - image.shape[0]) // 2
                    nra = (self.N_pix - image.shape[0]) - nrb
                    ncb = (self.N_pix - image.shape[1]) // 2
                    nca = (self.N_pix - image.shape[1]) - ncb
                    image = np.pad(image, ((nrb, nra), (ncb, nca)),
                                   mode="constant", constant_values=np.nan)
                    TESS_images.append(image)
                    col0 = hdu[1].header["1CRV4P"] - ncb
                    row0 = hdu[1].header["2CRV4P"] - nrb
            except Exception:
                print(f"Sector {sector} raised exception. "
                      "Ignoring for validation.")
                print(traceback.format_exc())
                continue
            col0s.append(col0)
            row0s.append(row0)
            pc = np.zeros([len(ra), 2])
            for i in range(len(ra)):
                RApix = wcs.all_world2pix(ra[i], dec[i], 0)[0].item()
                Decpix = wcs.all_world2pix(ra[i], dec[i], 0)[1].item()
                pc[i, 0] = col0 + RApix + ncb
                pc[i, 1] = row0 + Decpix + nrb
            pix_coords.append(pc)
        self.TESS_images = TESS_images
        self.col0s = col0s
        self.row0s = row0s
        self.pix_coords = pix_coords

    def _finish_init(self, stars):
        """Separation / position angle per star (triceratops.py:230-256)."""
        from astropy.coordinates import SkyCoord
        import astropy.units as u

        sep, pa = [0], [0]
        c_t = SkyCoord(stars["ra"].values[0], stars["dec"].values[0],
                       unit="deg")
        for i in range(1, len(stars)):
            c_s = SkyCoord(stars["ra"].values[i], stars["dec"].values[i],
                           unit="deg")
            sep.append(np.round(c_t.separation(c_s).to(u.arcsec).value, 3))
            pa.append(np.round(c_t.position_angle(c_s).to(u.deg).value, 3))
        stars["sep (arcsec)"] = sep
        stars["PA (E of N)"] = pa
        self.stars = stars

    # ------------------------------------------------------------------
    # Star-table edits (reference triceratops.py:265-335)
    # ------------------------------------------------------------------
    def add_star(self, ID: int, Tmag: float, bound: bool):
        """Add an unresolved follow-up star at the target's position."""
        import pandas as pd
        from pandas import DataFrame

        if bound:
            plx = self.stars["plx"].values[0]
            new_star = DataFrame([[str(ID), Tmag, plx]],
                                 columns=["ID", "Tmag", "plx"])
        else:
            new_star = DataFrame([[str(ID), Tmag]], columns=["ID", "Tmag"])
        self.stars = pd.concat([self.stars, new_star]).reset_index(drop=True)
        for i in range(len(self.pix_coords)):
            self.pix_coords[i] = np.append(
                self.pix_coords[i], self.pix_coords[i][0]
            ).reshape(len(self.pix_coords[i]) + 1, 2)

    def remove_star(self, drop_stars):
        """Drop stars (by ID) from the validation analysis."""
        if np.isscalar(drop_stars):
            drop_stars = [drop_stars]
        drop_stars = [str(s) for s in drop_stars]
        self.stars = self.stars[~self.stars["ID"].astype(str).isin(drop_stars)]

    def update_star(self, ID: int, param: str, value: float):
        """Update one parameter of one star."""
        idx = self.stars[self.stars.ID.astype(str) == str(ID)].index
        self.stars.loc[idx, [param]] = value

    def get_spoc_apertures(self):
        """SPOC apertures for the target's sectors, when available
        (reference triceratops.py:337-356)."""
        aps = []
        try:
            for sector in self.sectors:
                aps.append(get_aperture(self.ID, sector))
        except Exception:
            print("No SPOC apertures available.")
        return aps

    # ------------------------------------------------------------------
    def calc_depths(self, tdepth: float, all_ap_pixels=None):
        """Required transit depth per star from the analytic Gaussian-PSF
        (sigma = 0.75 px) aperture integral (reference
        triceratops.py:559-671; ndtr closed form :615-620)."""
        if all_ap_pixels is None:
            print("No apertures provided, assuming 5x5 centered on target.")
            all_ap_pixels = []
            for i in range(len(self.pix_coords)):
                tp = np.round(self.pix_coords[i][0])
                this_ap = np.array([
                    np.repeat(np.arange(tp[0] - 2, tp[0] + 3, 1), 5),
                    np.tile(np.arange(tp[1] - 2, tp[1] + 3, 1), 5),
                ]).T
                all_ap_pixels.append(this_ap)
        n_ap, n_star = len(all_ap_pixels), len(self.stars)
        flux_ratio = np.zeros([n_ap, n_star])
        sigma = 0.75
        amp = 10 ** ((np.min(self.stars.Tmag.values)
                      - self.stars.Tmag.values) / 2.5)       # (n_star,)
        for k in range(n_ap):
            pixels = np.asarray(all_ap_pixels[k], float)     # (n_pix, 2)
            mu = np.asarray(self.pix_coords[k], float)       # (n_star, 2)
            # broadcast (n_star, n_pix): per-pixel CDF-product PSF integral
            dx = (ndtr((pixels[None, :, 0] + 0.5 - mu[:, 0, None]) / sigma)
                  - ndtr((pixels[None, :, 0] - 0.5 - mu[:, 0, None]) / sigma))
            dy = (ndtr((pixels[None, :, 1] + 0.5 - mu[:, 1, None]) / sigma)
                  - ndtr((pixels[None, :, 1] - 0.5 - mu[:, 1, None]) / sigma))
            rel = amp * np.sum(dx * dy, axis=1)
            flux_ratio[k] = rel / np.sum(rel)
        flux_ratios = np.mean(flux_ratio, axis=0)
        self.stars["fluxratio"] = flux_ratios
        tdepths = np.where(flux_ratios != 0,
                           1 - (flux_ratios - tdepth)
                           / np.where(flux_ratios != 0, flux_ratios, 1.0),
                           0.0)
        tdepths[tdepths > 1] = 0
        self.stars["tdepth"] = tdepths

        filtered = self.stars[self.stars["tdepth"] > 0]
        for i, ID in enumerate(filtered["ID"].values):
            vals = filtered.iloc[i]
            missing = (np.isnan(vals["mass"]) or np.isnan(vals["rad"])
                       or np.isnan(vals["Teff"]))
            if i == 0 and (missing or np.isnan(vals["plx"])):
                print(f"WARNING: {ID} is missing stellar properties required "
                      "for validation. Please ensure a stellar mass (in "
                      "M_Sun), radius (in R_Sun), Teff (in K), and plx (in "
                      "mas) are provided in the .stars dataframe.")
            elif i > 0 and missing:
                print(f"WARNING: {ID} is missing stellar properties. If a "
                      "mass (in M_Sun), radius (in R_Sun), and/or Teff "
                      "(in K) are not added to the .stars dataframe, Solar "
                      "values will be assumed.")

    # ------------------------------------------------------------------
    def calc_probs(self, time: np.ndarray, flux_0: np.ndarray,
                   flux_err_0: float, P_orb, contrast_curve_file: str = None,
                   filt: str = "TESS", N: int = 1000000,
                   parallel: bool = False, drop_scenario: list = (),
                   verbose: int = 1, flatpriors: bool = False,
                   exptime: float = 0.00139, nsamples: int = 20,
                   molusc_file: str = None, key=None,
                   importance_sampling: bool = True,
                   lc_window: float = None):
        """Compute scenario probabilities, FPP and NFPP
        (reference triceratops.py:673-1485). ``parallel`` is accepted for
        signature parity; the engine is always vectorized.

        ``lc_window`` (days, no reference counterpart): if set, crop the
        folded light curve to |time| <= lc_window before analysis. Core
        cost is linear in the number of points, so windowing a long
        unbinned curve to its in-transit region cuts the core's work in
        proportion (TOI-1228: 20,099 -> 8,055 points), while the FPP
        shift (~0.001) is far inside the key-to-key Monte-Carlo scatter
        (sd ~0.015 at this target; bench_scripts/longlc_window_keys.py).
        Keep enough out-of-transit baseline for the noise to be
        identifiable (the reference's own example curves keep ~2-3
        transit durations)."""
        if "tdepth" not in self.stars.columns:
            raise RuntimeError(
                "calc_depths(tdepth, ...) must be called before "
                "calc_probs so each star's flux ratio and required "
                "transit depth are known.")
        mask = ~np.isnan(time) & ~np.isnan(flux_0)
        if lc_window is not None:
            mask &= np.abs(np.asarray(time)) <= float(lc_window)
        time = np.asarray(time)[mask]
        flux_0 = np.asarray(flux_0)[mask]

        filtered = self.stars[self.stars["tdepth"] > 0]
        N_scenarios = 3 * len(filtered) + 12
        cols = {f: np.zeros(N_scenarios) for f in _RES_FIELDS}
        lnZ = np.zeros(N_scenarios)
        targets = np.zeros(N_scenarios, dtype=np.int64)
        star_num = np.zeros(N_scenarios, dtype=np.int64)
        scenarios = np.zeros(N_scenarios, dtype="U6")

        if key is None:
            key = jax.random.key(int(np.random.randint(0, 2**31 - 1)))
        elif isinstance(key, (int, np.integer)):
            key = jax.random.key(int(key))

        # TRILEGAL result (downloaded once, memoized; triceratops.py:755-764)
        if self.trilegal_fname is None and self.trilegal_url is not None:
            fname = save_trilegal(self.trilegal_url, self.ID)
            self.trilegal_fname = fname if fname else None
        trilegal_fname = self.trilegal_fname
        trilegal_ok = bool(trilegal_fname)
        if not trilegal_ok and verbose:
            print("No TRILEGAL results available: DTP, DEB, DEBx2P, BTP, "
                  "BEB, and BEBx2P get zero weight.")

        deferred = []

        def put(j, ID, name, snum, res=None):
            targets[j] = int(ID)
            star_num[j] = snum
            scenarios[j] = name
            if res is None:
                lnZ[j] = -np.inf
            else:
                # results may hold device arrays; defer host conversion so
                # subsequent scenario dispatches overlap with this compute
                deferred.append((j, res))

        ikey = 0

        def subkey():
            nonlocal ikey
            ikey += 1
            return jax.random.fold_in(key, ikey)

        for i, ID in enumerate(filtered["ID"].values):
            flux, flux_err = renorm_flux(
                flux_0, flux_err_0, filtered["fluxratio"].values[i])
            M_s = filtered["mass"].values[i]
            R_s = filtered["rad"].values[i]
            Teff = filtered["Teff"].values[i]
            Tmag = filtered["Tmag"].values[i]
            Jmag = filtered["Jmag"].values[i]
            Hmag = filtered["Hmag"].values[i]
            Kmag = filtered["Kmag"].values[i]
            plx = filtered["plx"].values[i]
            Z = 0.0
            base = dict(N=N, parallel=parallel, mission=self.mission,
                        flatpriors=flatpriors, exptime=exptime,
                        nsamples=nsamples,
                        importance_sampling=importance_sampling)
            cc = dict(contrast_curve_file=contrast_curve_file, filt=filt)

            if i == 0:
                if (np.isnan(M_s) or np.isnan(R_s) or np.isnan(Teff)
                        or np.isnan(plx)):
                    print(f"Insufficient information to validate {ID}. "
                          "Please ensure a stellar mass (in M_Sun), radius "
                          "(in R_Sun), Teff (in K), and plx (in mas) are "
                          "provided in the .stars dataframe.")
                    break

                def log(name):
                    if verbose == 1:
                        print(f"Calculating {name} scenario probabilities "
                              f"for {ID}.")

                if "TP" in drop_scenario:
                    put(0, ID, "TP", 1)
                else:
                    log("TP")
                    res = sc.lnZ_TTP(time, flux, flux_err, P_orb, M_s, R_s,
                                     Teff, Z, **base, key=subkey())
                    put(0, ID, "TP", 1, res)
                if "EB" in drop_scenario:
                    put(1, ID, "EB", 1)
                    put(2, ID, "EBx2P", 1)
                else:
                    log("EB and EBx2P")
                    res, res_t = sc.lnZ_TEB(time, flux, flux_err, P_orb, M_s,
                                            R_s, Teff, Z, **base,
                                            key=subkey())
                    put(1, ID, "EB", 1, res)
                    put(2, ID, "EBx2P", 1, res_t)
                if "PTP" in drop_scenario:
                    put(3, ID, "PTP", 1)
                else:
                    log("PTP")
                    res = sc.lnZ_PTP(time, flux, flux_err, P_orb, M_s, R_s,
                                     Teff, Z, plx, **cc, **base,
                                     molusc_file=molusc_file, key=subkey())
                    put(3, ID, "PTP", 1, res)
                if "PEB" in drop_scenario:
                    put(4, ID, "PEB", 1)
                    put(5, ID, "PEBx2P", 1)
                else:
                    log("PEB and PEBx2P")
                    res, res_t = sc.lnZ_PEB(time, flux, flux_err, P_orb, M_s,
                                            R_s, Teff, Z, plx, **cc, **base,
                                            molusc_file=molusc_file,
                                            key=subkey())
                    put(4, ID, "PEB", 1, res)
                    put(5, ID, "PEBx2P", 1, res_t)
                if "STP" in drop_scenario:
                    put(6, ID, "STP", 2)
                else:
                    log("STP")
                    res = sc.lnZ_STP(time, flux, flux_err, P_orb, M_s, R_s,
                                     Teff, Z, plx, **cc, **base,
                                     molusc_file=molusc_file, key=subkey())
                    put(6, ID, "STP", 2, res)
                if "SEB" in drop_scenario:
                    put(7, ID, "SEB", 2)
                    put(8, ID, "SEBx2P", 2)
                else:
                    log("SEB and SEBx2P")
                    res, res_t = sc.lnZ_SEB(time, flux, flux_err, P_orb, M_s,
                                            R_s, Teff, Z, plx, **cc, **base,
                                            molusc_file=molusc_file,
                                            key=subkey())
                    put(7, ID, "SEB", 2, res)
                    put(8, ID, "SEBx2P", 2, res_t)
                if "DTP" in drop_scenario or not trilegal_ok:
                    put(9, ID, "DTP", 1)
                else:
                    log("DTP")
                    res = sc.lnZ_DTP(time, flux, flux_err, P_orb, M_s, R_s,
                                     Teff, Z, Tmag, Jmag, Hmag, Kmag,
                                     trilegal_fname, **cc, **base,
                                     key=subkey())
                    put(9, ID, "DTP", 1, res)
                if "DEB" in drop_scenario or not trilegal_ok:
                    put(10, ID, "DEB", 1)
                    put(11, ID, "DEBx2P", 1)
                else:
                    log("DEB and DEBx2P")
                    res, res_t = sc.lnZ_DEB(time, flux, flux_err, P_orb, M_s,
                                            R_s, Teff, Z, Tmag, Jmag, Hmag,
                                            Kmag, trilegal_fname, **cc,
                                            **base, key=subkey())
                    put(10, ID, "DEB", 1, res)
                    put(11, ID, "DEBx2P", 1, res_t)
                if "BTP" in drop_scenario or not trilegal_ok:
                    put(12, ID, "BTP", 2)
                else:
                    log("BTP")
                    res = sc.lnZ_BTP(time, flux, flux_err, P_orb, M_s, R_s,
                                     Teff, Tmag, Jmag, Hmag, Kmag,
                                     trilegal_fname, **cc, **base,
                                     key=subkey())
                    put(12, ID, "BTP", 2, res)
                if "BEB" in drop_scenario or not trilegal_ok:
                    put(13, ID, "BEB", 2)
                    put(14, ID, "BEBx2P", 2)
                else:
                    log("BEB and BEBx2P")
                    res, res_t = sc.lnZ_BEB(time, flux, flux_err, P_orb, M_s,
                                            R_s, Teff, Tmag, Jmag, Hmag,
                                            Kmag, trilegal_fname, **cc,
                                            **base, key=subkey())
                    put(13, ID, "BEB", 2, res)
                    put(14, ID, "BEBx2P", 2, res_t)
            else:
                # nearby stars: solar fallbacks for missing properties
                # (reference triceratops.py:1344-1363)
                if np.isnan(Teff):
                    Teff = 5777.0
                if np.isnan(M_s):
                    M_s = 1.0
                if np.isnan(R_s):
                    R_s = 1.0
                if verbose == 1:
                    print("Calculating NTP, NEB, and NEB2xP scenario "
                          f"probabilities for {ID}.")
                res = sc.lnZ_TTP(time, flux, flux_err, P_orb, M_s, R_s, Teff,
                                 Z, **base, key=subkey())
                put(15 + 3 * (i - 1), ID, "NTP", 1, res)
                res, res_t = sc.lnZ_TEB(time, flux, flux_err, P_orb, M_s,
                                        R_s, Teff, Z, **base, key=subkey())
                put(16 + 3 * (i - 1), ID, "NEB", 1, res)
                put(17 + 3 * (i - 1), ID, "NEBx2P", 1, res_t)

        # materialize all deferred device results in ONE transfer: only
        # the best-fit (first) element of each gathered field is needed
        # here, so a single stacking program + single pull replaces ~270
        # per-field device->host copies.
        if deferred:
            nf = 1 + len(_RES_FIELDS)
            vals = np.empty((len(deferred), nf))
            dev_leaves, dev_slots = [], []
            for i, (_, res) in enumerate(deferred):
                for fi, f in enumerate(("lnZ",) + tuple(_RES_FIELDS)):
                    v = res[f]
                    if isinstance(v, jax.Array):
                        dev_slots.append((i, fi))
                        dev_leaves.append(v)
                    else:
                        vals[i, fi] = float(np.atleast_1d(np.asarray(v))[0])
            if dev_leaves:
                flat = np.asarray(_stack_firsts(tuple(dev_leaves)))
                for (i, fi), x in zip(dev_slots, flat):
                    vals[i, fi] = float(x)
            for i, (j, _) in enumerate(deferred):
                lnZ[j] = vals[i, 0]
                for fi, f in enumerate(_RES_FIELDS):
                    cols[f][j] = vals[i, 1 + fi]

        relative_probs, _status = normalize_probabilities(lnZ)
        if _status == "anomaly":
            warnings.warn(
                "Unexpected NaN or +inf in scenario log-evidences. This "
                "indicates a numerical anomaly unrelated to geometric "
                "exclusions. Inspect self.lnZ for diagnostics.",
                RuntimeWarning, stacklevel=2)
            self.FPP_degenerate = True
        elif _status == "all_neginf":
            warnings.warn(
                "All scenario log-evidences are -inf: every MC draw was "
                "geometrically invalid. FPP=1.0 reflects a failed "
                "computation, not a confident false positive. Inspect "
                "self.lnZ for diagnostics.",
                RuntimeWarning, stacklevel=2)
            self.FPP_degenerate = True
        else:
            self.FPP_degenerate = False

        from pandas import DataFrame

        prob_df = DataFrame({
            "ID": targets, "scenario": scenarios,
            "M_s": cols["M_s"], "R_s": cols["R_s"], "P_orb": cols["P_orb"],
            "inc": cols["inc"], "b": cols["b"], "ecc": cols["ecc"],
            "w": cols["argp"], "R_p": cols["R_p"], "M_EB": cols["M_EB"],
            "R_EB": cols["R_EB"], "prob": relative_probs,
        })
        self.probs = prob_df
        self.lnZ = lnZ
        self.star_num = star_num
        self.u1 = cols["u1"]
        self.u2 = cols["u2"]
        self.fluxratio_EB = cols["fluxratio_EB"]
        self.fluxratio_comp = cols["fluxratio_comp"]
        # clip the f32 rounding residue when the planet scenarios carry
        # ~all probability (1 - sum can land at -1e-15)
        self.FPP = max(
            1 - (prob_df.prob[0] + prob_df.prob[3] + prob_df.prob[9]), 0.0)
        if len(prob_df.prob) > 15:
            self.NFPP = np.sum(prob_df.prob[15:])
        else:
            self.NFPP = 0.0

    def calc_probs_ensemble(self, time, flux_0, flux_err_0, P_orb,
                            n_runs: int = 20, key=None, **kwargs):
        """Repeat calc_probs over independent PRNG keys and aggregate.

        The reference quantifies Monte-Carlo scatter by re-running the
        analysis ~20 times and averaging by hand (examples/example.ipynb
        cell 14); this does that in one call. Sets ``FPP``/``NFPP`` to
        the ensemble means and ``FPP_std``/``NFPP_std``/``FPP_runs``/
        ``NFPP_runs`` to the scatter; ``probs`` etc. reflect the last
        run."""
        if key is None:
            key = jax.random.key(int(np.random.randint(0, 2**31 - 1)))
        elif isinstance(key, (int, np.integer)):
            key = jax.random.key(int(key))
        fpps, nfpps = [], []
        for i in range(n_runs):
            self.calc_probs(time, flux_0, flux_err_0, P_orb,
                            key=jax.random.fold_in(key, i), **kwargs)
            fpps.append(self.FPP)
            nfpps.append(self.NFPP)
        self.FPP_runs = np.array(fpps)
        self.NFPP_runs = np.array(nfpps)
        self.FPP = float(self.FPP_runs.mean())
        self.NFPP = float(self.NFPP_runs.mean())
        self.FPP_std = float(self.FPP_runs.std())
        self.NFPP_std = float(self.NFPP_runs.std())

    # ------------------------------------------------------------------
    def plot_field(self, sector: int = None, ap_pixels=None,
                   ap_color: str = "red", save: bool = False,
                   fname: str = None):
        """Field plot: star positions + mean FFI image
        (reference triceratops.py:358-557)."""
        from ..frontend.plotting import plot_field as _pf
        return _pf(self, sector=sector, ap_pixels=ap_pixels,
                   ap_color=ap_color, save=save, fname=fname)

    def plot_fits(self, time: np.ndarray, flux_0: np.ndarray,
                  flux_err_0: float, save: bool = False, fname: str = None):
        """Best-fit light-curve grid (reference triceratops.py:1487-1638)."""
        from ..frontend.plotting import plot_fits as _pfits
        return _pfits(self, time, flux_0, flux_err_0, save=save, fname=fname)
