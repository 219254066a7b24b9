"""Band-wise gas optics for the multi-band radiation scheme.

Plays the role of the reference's `radiation_gases.py` (GasClass,
~700 LoC: global-mean CO2/rare-gas climatology + seasonal update) plus
the k-distribution tables baked into `radlw/radlw_main.py` and
`radsw/radsw_main.py` (reference external/radiation; see
radiation_driver.py:18).  Design: instead of 140/112
g-points with pentadecadal lookup tables, each band carries a small set
of mass-absorption coefficients (m^2/kg) for the active absorbers
(H2O, CO2, O3) plus a pressure-broadening exponent; optical depth is a
pure elementwise expression over [band, level, column] arrays, which
XLA fuses into the two-stream solvers.

The band structure below is a reduced (8 LW / 6 SW band) correlated-k
style model.  Band limits follow the RRTMG groupings (combined);
coefficients are tuned so clear-sky OLR, surface fluxes and heating
rates land in the physically expected range (validated in
tests/test_radiation.py: OLR vs sigma*T^4 bounds, energy conservation,
heating-rate magnitudes).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import GRAV

# --- LW band structure: the 16 RRTMG_LW bands (wavenumber limits,
# cm^-1; radlw_main.py / radlw_param `wvnlw1/wvnlw2`) -------------------
LW_BAND_LIMITS = np.array(
    [
        [10.0, 350.0],     # 1: H2O rotation
        [350.0, 500.0],    # 2: H2O rotation wing
        [500.0, 630.0],    # 3: H2O / CO2 overlap
        [630.0, 700.0],    # 4: CO2 15um core
        [700.0, 820.0],    # 5: CO2 15um wing
        [820.0, 980.0],    # 6: window
        [980.0, 1080.0],   # 7: O3 9.6um
        [1080.0, 1180.0],  # 8: window / weak H2O
        [1180.0, 1390.0],  # 9: CH4/N2O region (weak H2O here)
        [1390.0, 1480.0],  # 10: H2O nu2 core
        [1480.0, 1800.0],  # 11: H2O nu2
        [1800.0, 2080.0],  # 12: H2O/CO2
        [2080.0, 2250.0],  # 13: N2O/CO2 region
        [2250.0, 2380.0],  # 14: CO2 4.3um core
        [2380.0, 2600.0],  # 15: CO2 4.3um wing
        [2600.0, 3250.0],  # 16: H2O 2.7um
    ]
)
NBANDS_LW = len(LW_BAND_LIMITS)

# band-mean mass absorption coefficients (m^2/kg of absorber)
LW_K_H2O = np.array(
    [25.0, 6.0, 2.5, 0.8, 0.45, 0.045, 0.09, 0.12,
     0.35, 6.0, 3.0, 1.2, 0.5, 0.05, 0.1, 1.5]
)
LW_K_CO2 = np.array(
    [0.0, 0.12, 0.2, 75.0, 9.0, 0.02, 0.0, 0.02,
     0.05, 0.0, 0.0, 0.3, 1.5, 60.0, 8.0, 0.4]
)
LW_K_O3 = np.array(
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 28.0, 0.0,
     0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
)
# water-vapor self-continuum (scaled by vapor path * vapor pressure)
LW_K_SELF = np.array(
    [4.5, 2.6, 2.0, 0.6, 0.7, 0.55, 0.30, 0.26,
     0.26, 0.8, 0.65, 0.4, 0.3, 0.1, 0.1, 0.3]
)

# --- SW band structure: the 14 RRTMG_SW bands (radsw_main.py /
# radsw_param `wvnum1/wvnum2`, bands jpb16-29), ordered short -> long
# wavelength; the last band is RRTMG's wrap-around 820-2600 cm^-1 -----
SW_BAND_LIMITS_CM1 = np.array(
    [
        [38000.0, 50000.0],  # 0.20-0.263 um: O3 Hartley
        [29000.0, 38000.0],  # 0.263-0.345: O3 Hartley/Huggins
        [22650.0, 29000.0],  # 0.345-0.44: UV-A
        [16000.0, 22650.0],  # 0.44-0.625: visible, O3 Chappuis
        [12850.0, 16000.0],  # 0.625-0.78: red
        [8050.0, 12850.0],   # 0.78-1.24: NIR, 0.94/1.1um H2O
        [7700.0, 8050.0],    # 1.24-1.30: O2/H2O
        [6150.0, 7700.0],    # 1.30-1.63: 1.38um H2O (strong)
        [5150.0, 6150.0],    # 1.63-1.94: 1.87um H2O
        [4650.0, 5150.0],    # 1.94-2.15: H2O/CO2
        [4000.0, 4650.0],    # 2.15-2.50: H2O/CH4
        [3250.0, 4000.0],    # 2.50-3.08: 2.7um H2O/CO2
        [2600.0, 3250.0],    # 3.08-3.85: H2O
        [820.0, 2600.0],     # 3.85-12.2: solar tail (wrap band)
    ]
)
SW_BAND_RANGE_UM = 1e4 / SW_BAND_LIMITS_CM1[:, ::-1]
# band is in the UV-visible albedo window (lambda < 0.7 um, the
# setalb/radiation_surface.py uvb-vs-nir split)
SW_BAND_UVVIS = SW_BAND_LIMITS_CM1[:, 0] >= 14286.0
# fraction of TOA solar irradiance per band (Kurucz spectrum integrated
# over the RRTMG limits, normalized; sums to 1)
SW_BAND_FRAC = np.array(
    [0.0091, 0.0345, 0.1085, 0.2126, 0.1638, 0.2665, 0.0165,
     0.0560, 0.0377, 0.0079, 0.0155, 0.0237, 0.0021, 0.0456]
)
SW_K_H2O = np.array(
    [0.0, 0.0, 0.0, 0.0, 0.002, 0.08, 0.35,
     1.6, 1.2, 2.5, 3.5, 8.0, 15.0, 30.0]
)
SW_K_O3 = np.array(
    [900.0, 120.0, 2.0, 5.5, 2.0, 0.0, 0.0,
     0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
)
SW_K_CO2 = np.array(
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
     0.003, 0.01, 0.04, 0.08, 0.25, 0.10, 0.80]
)
# Rayleigh optical depth per unit (p/p0) of column, per band
# (~0.0088 lambda^-4 at the band-center wavelengths)
SW_TAU_RAYLEIGH = np.array(
    [3.1, 1.05, 0.37, 0.112, 0.037, 0.0097, 0.0034,
     0.0019, 0.00088, 0.00051, 0.00031, 0.00014, 6e-05, 1e-05]
)
NBANDS_SW = len(SW_BAND_FRAC)

# --- correlated-k g-point quadrature ---------------------------------
# Each band's k-distribution is represented by a small exponential-sum
# quadrature: tau_g = mult_g * k_band * u, flux = sum_g w_g * flux_g.
# The multipliers span the weak-to-strong line range of a Malkmus band
# (the role of RRTMG's 112/140 per-band g-points, radsw_main.py /
# radlw_main.py absorption-coefficient tables); sum(w) = 1 and
# sum(w*mult) = 1 so the band-mean optical depth is preserved while
# the band TRANSMISSION follows a curve-of-growth instead of a single
# exponential.
SW_GPT_MULT = np.array([0.08, 0.40, 1.60, 6.00])
SW_GPT_W = np.array([0.35, 0.35, 0.22, 0.08])
LW_GPT_MULT = np.array([0.08, 0.40, 1.60, 6.00])
LW_GPT_W = np.array([0.35, 0.35, 0.22, 0.08])
NGPT_SW = len(SW_GPT_W)
NGPT_LW = len(LW_GPT_W)


@dataclasses.dataclass
class GasConcentrations:
    """Well-mixed gas volume mixing ratios (GasClass role,
    radiation_gases.py): CO2 with a secular trend, fixed CH4/N2O folded
    into effective CO2."""

    co2_ppmv: float = 420.0

    def co2_mass_mixing_ratio(self) -> float:
        return self.co2_ppmv * 1e-6 * (44.01 / 28.964)


def default_o3_profile(p_lay):
    """Global-mean climatological ozone mass mixing ratio on pressure
    levels: peaked in the stratosphere around 10-30 hPa.
    jnp-traceable.  Prefer ozone_climatology (lat/season structure)."""
    import jax.numpy as jnp

    logp = jnp.log(jnp.maximum(p_lay, 1.0))
    peak = jnp.exp(-0.5 * ((logp - np.log(2.0e3)) / 0.9) ** 2)
    return 1.0e-5 * peak + 3.0e-8


def ozone_climatology(p_lay, lat_deg, doy):
    """Latitude/season-dependent ozone climatology (the role of the
    reference's `ozprdlc` climatology files read by GasClass/getozn,
    external/radiation/radiation/radiation_gases.py; data files are
    not shipped in this environment, so the observed structure is
    encoded analytically):

    * total-column: ~260 DU in the tropics rising to ~380 DU at high
      latitudes, with a spring maximum in each hemisphere (+/- ~12%%
      peaking around day 105 / 288);
    * profile: the stratospheric peak sits near 8 hPa over the equator
      and descends to ~30 hPa toward the poles, with a broader peak at
      high latitude;
    * a small tropospheric background (~30 ppbm).

    p_lay [.., nz, ..] Pa; lat_deg broadcastable to the horizontal
    dims; doy day-of-year (scalar).  Returns mass mixing ratio with
    p_lay's shape.  jnp-traceable (jittable inside the driver).
    """
    import jax.numpy as jnp

    lat = jnp.deg2rad(lat_deg)
    if jnp.ndim(lat) == p_lay.ndim - 1:
        lat = lat[:, None]  # broadcast over the level axis
    sin2 = jnp.sin(lat) ** 2
    # peak pressure: 8 hPa (equator) -> ~30 hPa (poles)
    p_peak = 800.0 * (1.0 + 2.75 * sin2)
    width = 0.85 + 0.35 * sin2  # broader poleward
    logp = jnp.log(jnp.maximum(p_lay, 1.0))
    shape = jnp.exp(
        -0.5 * ((logp - jnp.log(p_peak)) / width) ** 2
    )
    # column amount: latitude + spring-maximum seasonal cycle
    phase_n = jnp.cos(2.0 * jnp.pi * (doy - 105.0) / 365.25)
    phase_s = jnp.cos(2.0 * jnp.pi * (doy - 288.0) / 365.25)
    seasonal = jnp.where(lat >= 0.0, phase_n, phase_s)
    column = (1.0 + 0.45 * sin2) * (
        1.0 + 0.12 * seasonal * jnp.abs(jnp.sin(lat))
    )
    return 1.0e-5 * column * shape + 3.0e-8


def co2_for_year(year: float) -> float:
    """Secular CO2 trend in ppmv (the GasClass `ico2flg=1` observed
    global-annual-mean role, radiation_gases.py): anchored at
    ~354 ppmv in 1990 with the observed accelerating growth."""
    dy = float(year) - 1990.0
    return 354.0 + 1.9 * dy + 0.011 * dy * dy


def absorber_paths(delp, sphum, o3mmr, co2mmr):
    """Mass paths (kg/m^2) of each absorber per layer.

    delp [..., nz, ...] in Pa; sphum/o3mmr mass mixing ratios.
    Returns (u_h2o, u_co2, u_o3) with delp's shape.
    """
    air = delp / GRAV
    return sphum * air, co2mmr * air, o3mmr * air
