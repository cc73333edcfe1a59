"""Deterministic synthetic spectral-data fixtures.

A copy of pylbl_tpu/database/fixtures.py: the same seed gives the same
LinePack in both packages (held byte-identical by the tests).

The reference test-suite depends on live HITRAN/TIPS downloads or a prebuilt
FTP snapshot (reference tests/conftest.py:116-124) — unusable offline.  This
module generates reproducible pseudo-HITRAN line lists, TIPS tables and
cross-section coefficient sets with realistic parameter distributions, used
to (a) run the test-suite hermetically and (b) drive parity checks against
the compiled reference-C oracle.
"""
import numpy as np

from ..models.lines.physics import LinePack


def synthetic_tips(num_iso, seed=7, num_t=5000):
    """TIPS-2017-like tables: Q grows ~ T^1.5 with per-iso scaling, on the
    1 K grid T = 1..num_t the reference C interpolation assumes
    (reference spectral_database.c:97-104, tests/test_database.py:24-25)."""
    rng = np.random.default_rng(seed)
    temperature = np.arange(1.0, num_t + 1.0)
    scale = rng.uniform(0.5, 6.0, size=num_iso)
    power = rng.uniform(1.0, 1.8, size=num_iso)
    data = scale[:, None] * (temperature[None, :] / 296.0) ** power[:, None] \
        * 160.0 + 1.0
    return temperature, data


def synthetic_line_pack(formula="H2O", num_lines=2000, nu_min=0.1,
                        nu_max=3400.0, num_iso=3, seed=1234,
                        band_centers=(1600.0, 3100.0, 150.0)):
    """Generates a nu-sorted LinePack with HITRAN-like parameter ranges.

    Line positions cluster around band centers (plus a uniform background)
    so the bucket occupancy is non-uniform like real molecules; intensities
    are log-uniform over ~8 decades; broadening parameters sit in typical
    HITRAN ranges.
    """
    rng = np.random.default_rng(seed)
    n_band = int(num_lines * 0.7) // max(len(band_centers), 1)
    nus = [rng.uniform(nu_min, nu_max, size=num_lines - n_band *
                       len(band_centers))]
    for center in band_centers:
        nus.append(np.clip(rng.normal(center, 60.0, size=n_band),
                           nu_min, nu_max))
    nu = np.sort(np.concatenate(nus))
    num = nu.size
    sw = 10.0 ** rng.uniform(-28.0, -20.0, size=num)
    gamma_air = rng.uniform(0.01, 0.12, size=num)
    gamma_self = rng.uniform(0.05, 0.6, size=num)
    n_air = rng.uniform(0.3, 0.9, size=num)
    delta_air = rng.uniform(-0.02, 0.02, size=num)
    elower = rng.uniform(0.0, 4000.0, size=num)
    iso = rng.integers(1, num_iso + 1, size=num)
    mass_slots = np.zeros(32)
    mass_slots[:num_iso] = 18.010565 + np.arange(num_iso)
    temperature, q_table = synthetic_tips(num_iso, seed=seed + 1)
    return LinePack(
        formula=formula, nu=nu, sw=sw, gamma_air=gamma_air,
        gamma_self=gamma_self, n_air=n_air, delta_air=delta_air,
        elower=elower, iso=iso, mass_slots=mass_slots, q_table=q_table,
        q_temperature=temperature,
        meta={"synthetic": True, "seed": seed})
