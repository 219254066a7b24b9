"""Radiation driver (the external/radiation package's role).

The reference carries a pure-Python port of the GFS RRTMG radiation
(radiation_driver.py:18, radsw/radlw ~6.5k LoC) exposed through a
`Radiation` facade (wrapper_api.py:119) and driven by `RadiationStepper`
(runtime/steppers/radiation.py:27).  The full two-stream RRTMG port is a
later milestone; this module provides the same driver/facade structure
with a gray-atmosphere two-stream scheme (one SW band with zenith-angle
geometry + one LW band with a water-vapor-weighted emissivity), which
produces physically-shaped heating rates and surface fluxes so the
coupling, diagnostics and override machinery run end to end.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Mapping

import jax.numpy as np  # noqa: jnp under the reference's np spelling

from ..constants import CP_AIR, GRAV
from ..utils.zenith import cos_zenith_angle

SOLAR_CONSTANT = 1361.0  # W/m^2
STEFAN_BOLTZMANN = 5.670374e-8


@dataclasses.dataclass
class GFSPhysicsControl:
    """(wrapper_api.py:40): radiation cadence control."""

    fhswr: float = 3600.0  # SW call interval (s)
    fhlwr: float = 3600.0
    nsswr: int = 4
    nslwr: int = 4


class RadiationDriver:
    """(radiation_driver.py:18): holds slowly-varying inputs, exposes
    radupdate + the per-step driver call."""

    def __init__(self, sw_tau0: float = 0.2, lw_tau0: float = 4.0,
                 albedo: float = 0.12):
        import jax

        self.sw_tau0 = sw_tau0
        self.lw_tau0 = lw_tau0
        self.albedo = albedo
        self._solcon = SOLAR_CONSTANT
        # the array math is jnp: jit it once so the per-step call is a
        # single dispatch, not ~25 eager ops
        self._jit_core = jax.jit(self._core)

    def radupdate(self, time: datetime.datetime):
        """(radiation_driver.py:209): update solar constant etc."""
        # annual cycle of earth-sun distance (+/- 3.4%)
        doy = time.timetuple().tm_yday
        self._solcon = SOLAR_CONSTANT * (
            1.0 + 0.034 * np.cos(2 * np.pi * (doy - 3) / 365.25)
        )

    def gfs_radiation_driver(
        self, time, lon_deg, lat_deg, p_lay, delp, temp, sphum, tsfc
    ) -> Mapping[str, np.ndarray]:
        """(radiation_driver.py:354): compute SW/LW heating rates and
        surface/TOA fluxes.

        All fields [6, nz, n, n] except lon/lat/tsfc [6, n, n].
        """
        import numpy as onp

        cosz = np.asarray(
            onp.maximum(
                onp.asarray(cos_zenith_angle(time, lon_deg, lat_deg)),
                0.0,
            )
        )
        return self._jit_core(
            cosz, p_lay, delp, temp, sphum, tsfc,
            np.asarray(self._solcon, np.float32),
        )

    def _core(self, cosz, p_lay, delp, temp, sphum, tsfc, solcon):
        # --- shortwave: gray absorption along the slant path ----------
        # optical depth per layer proportional to mass + vapor loading
        dtau = (
            self.sw_tau0
            * (delp / delp.sum(axis=1, keepdims=True))
            * (1.0 + 20.0 * sphum)
        )
        slant = 1.0 / np.maximum(cosz, 0.05)[:, None]
        trans = np.exp(-np.cumsum(dtau, axis=1) * slant)
        toa_down = solcon * cosz
        flux_dn = toa_down[:, None] * np.concatenate(
            [np.ones_like(trans[:, :1]), trans], axis=1
        )  # [6, nz+1, n, n]
        sfc_down = flux_dn[:, -1]
        absorbed = flux_dn[:, :-1] - flux_dn[:, 1:]
        sw_heating = GRAV * absorbed / (CP_AIR * delp)  # K/s
        sfc_net_sw = sfc_down * (1.0 - self.albedo)

        # --- longwave: emissivity-weighted exchange with surface ------
        dtau_lw = (
            self.lw_tau0
            * (delp / delp.sum(axis=1, keepdims=True))
            * (1.0 + 50.0 * sphum)
        )
        eps = 1.0 - np.exp(-dtau_lw)
        sigma_t4 = STEFAN_BOLTZMANN * temp ** 4
        # downward LW at surface: sum of layer emissions attenuated
        below = np.cumsum(dtau_lw[:, ::-1], axis=1)[:, ::-1] - dtau_lw
        sfc_down_lw = (eps * sigma_t4 * np.exp(-below)).sum(axis=1)
        up_sfc = STEFAN_BOLTZMANN * tsfc ** 4
        # cooling-to-space approximation for heating rates
        above = np.cumsum(dtau_lw, axis=1) - dtau_lw
        lw_cooling = (
            -GRAV * eps * sigma_t4 * np.exp(-above) / (CP_AIR * delp)
        )
        return {
            "total_sky_downward_shortwave_flux_at_surface": sfc_down,
            "total_sky_net_shortwave_flux_at_surface": sfc_net_sw,
            "total_sky_downward_longwave_flux_at_surface": sfc_down_lw,
            "total_sky_upward_longwave_flux_at_surface": up_sfc,
            "shortwave_heating_rate": sw_heating,
            "longwave_heating_rate": lw_cooling,
            "total_sky_downward_shortwave_flux_at_top_of_atmosphere":
                toa_down,
        }


class MultibandRadiationDriver:
    """Multi-band RRTMG-role driver (radiation_driver.py:18): SW
    delta-Eddington two-stream + adding (radsw.py), LW band absorption
    (radlw.py), cloud/aerosol/gas optics (radclouds/radgases), all
    jitted over [band, nz, columns] batches.

    Same call contract as the gray `RadiationDriver` so the `Radiation`
    facade and `RadiationStepper` drive either scheme.
    """

    def __init__(self, albedo: float = None, co2_ppmv: float = 420.0):
        import jax

        from . import radlw, radsw
        from .radgases import GasConcentrations, ozone_climatology

        # albedo=None (default): the zenith/type/snow-dependent scheme
        # (radsurface.surface_albedo, the setalb role); a float pins a
        # constant albedo (legacy behavior, used by oracle tests)
        self.albedo = albedo
        gases = GasConcentrations(co2_ppmv=co2_ppmv)
        self._sw = radsw.RadSWClass(gases=gases)
        self._lw = radlw.RadLWClass(gases=gases)
        self._o3 = ozone_climatology
        self._solcon = SOLAR_CONSTANT
        self._doy = 1.0
        self._jit = jax.jit(self._compute)

    def radupdate(self, time: datetime.datetime):
        """(radiation_driver.py:209): annual solar-constant cycle +
        the aerosol climatology's seasonal phase."""
        doy = time.timetuple().tm_yday
        self._doy = float(doy)
        self._solcon = SOLAR_CONSTANT * (
            1.0 + 0.034 * np.cos(2 * np.pi * (doy - 3) / 365.25)
        )

    def _compute(self, cosz, p_lay, delp, temp, sphum, ql, qi, tsfc,
                 solcon, lat_deg, doy, land_mask, snow):
        import jax.numpy as jnp

        from .radclouds import cloud_fraction_from_rh
        from .radsurface import surface_albedo, surface_emissivity
        from ..utils.thermo import relative_humidity_from_pressure

        o3 = self._o3(p_lay, lat_deg, doy)
        rh = relative_humidity_from_pressure(temp, sphum, p_lay)
        cf = cloud_fraction_from_rh(rh)

        def cols(x):  # [6, nz, n, n] -> [nz, 6, n, n]
            return jnp.moveaxis(x, 1, 0)

        if self.albedo is None:
            # spectral direct/diffuse x UV-VIS/NIR components (setalb
            # contract); radsw selects the window per band
            from .radsurface import surface_albedo_spectral

            alb = surface_albedo_spectral(
                jnp.maximum(cosz, 0.0), land_mask, snow
            )
            emis = surface_emissivity(land_mask, snow)
        else:
            alb = jnp.full_like(tsfc, self.albedo)
            emis = 0.98
        aod = self._sw.aerosols.aod550_field(lat_deg, doy)
        sw = self._sw(
            jnp.maximum(cosz, 0.0), cols(p_lay), cols(delp),
            cols(sphum), cols(o3), cols(ql), cols(qi), cols(cf),
            alb, solcon, aod550=aod,
        )
        lw = self._lw(
            cols(p_lay), cols(delp), cols(temp), cols(sphum),
            cols(o3), cols(ql), cols(qi), cols(cf), tsfc,
            sfc_emissivity=emis,
        )

        def rows(x):  # [nz(+1), 6, n, n] -> [6, nz(+1), n, n]
            return jnp.moveaxis(x, 0, 1)

        return {
            "total_sky_downward_shortwave_flux_at_surface":
                sw["sfc_dn"],
            "total_sky_net_shortwave_flux_at_surface": sw["sfc_net"],
            "total_sky_downward_longwave_flux_at_surface":
                lw["sfc_dn"],
            "total_sky_upward_longwave_flux_at_surface": lw["sfc_up"],
            "shortwave_heating_rate": rows(sw["heating_rate"]),
            "longwave_heating_rate": rows(lw["heating_rate"]),
            "total_sky_downward_shortwave_flux_at_top_of_atmosphere":
                sw["toa_dn"],
            "total_sky_upward_shortwave_flux_at_top_of_atmosphere":
                sw["toa_up"],
            "total_sky_upward_longwave_flux_at_top_of_atmosphere":
                lw["olr"],
        }

    def gfs_radiation_driver(
        self, time, lon_deg, lat_deg, p_lay, delp, temp, sphum, tsfc,
        ql=None, qi=None, land_mask=None, snow=None,
    ) -> Mapping[str, np.ndarray]:
        """(radiation_driver.py:354). Fields [6, nz, n, n]; lon/lat/
        tsfc [6, n, n]; ql/qi optional condensate mixing ratios;
        land_mask (1=land)/snow (kg/m^2 SWE) feed the surface
        albedo/emissivity scheme (radsurface)."""
        import jax.numpy as jnp

        cosz = np.maximum(cos_zenith_angle(time, lon_deg, lat_deg), 0.0)
        if ql is None:
            ql = np.zeros_like(sphum)
        if qi is None:
            qi = np.zeros_like(sphum)
        if land_mask is None:
            land_mask = np.zeros_like(tsfc)
        if snow is None:
            snow = np.zeros_like(tsfc)
        out = self._jit(
            jnp.asarray(cosz), jnp.asarray(p_lay), jnp.asarray(delp),
            jnp.asarray(temp), jnp.asarray(sphum), jnp.asarray(ql),
            jnp.asarray(qi), jnp.asarray(tsfc),
            jnp.asarray(self._solcon), jnp.asarray(lat_deg),
            jnp.asarray(self._doy), jnp.asarray(land_mask),
            jnp.asarray(snow),
        )
        return {k: np.asarray(v) for k, v in out.items()}


class Radiation:
    """Facade wiring the driver to wrapper state names
    (wrapper_api.py:119)."""

    def __init__(self, driver: RadiationDriver = None,
                 control: GFSPhysicsControl = None):
        self.driver = driver or RadiationDriver()
        self.control = control or GFSPhysicsControl()
        self._last_update = None

    def __call__(self, time, state) -> Mapping[str, np.ndarray]:
        from ..runtime import names
        from ..utils.thermo import pressure_at_midpoint_log

        if (
            self._last_update is None
            or (time - self._last_update).total_seconds()
            >= self.control.fhswr
        ):
            self.driver.radupdate(time)
            self._last_update = time
        delp = state[names.DELP].values
        temp = state[names.TEMP].values
        sphum = state[names.SPHUM].values
        tsfc = state[names.TSFC].values
        lat = np.rad2deg(state["latitude"].values)
        lon = np.rad2deg(state["longitude"].values)
        p_lay = pressure_at_midpoint_log(delp, axis=1)
        return self.driver.gfs_radiation_driver(
            time, lon, lat, p_lay, delp, temp, sphum, tsfc
        )


class RadiationStepper:
    """Stepper applying radiative heating to the model state
    (runtime/steppers/radiation.py:27)."""

    label = "radiation"

    def __init__(self, radiation: Radiation, dt: float):
        self.radiation = radiation
        self.dt = dt

    def __call__(self, time, state):
        from ..runtime import names
        from ..util.quantity import Quantity

        out = self.radiation(time, state)
        heating = (
            out["shortwave_heating_rate"]
            + out["longwave_heating_rate"]
        )
        diags = {
            k: Quantity(
                v,
                ("tile", "z", "y", "x")[: np.ndim(v)]
                if np.ndim(v) == 4
                else ("tile", "y", "x"),
                "W/m**2" if "flux" in k else "K/s",
            )
            for k, v in out.items()
        }
        tendencies = {
            "dQ1": Quantity(heating, ("tile", "z", "y", "x"), "K/s")
        }
        return tendencies, diags, {}

    def get_diagnostics(self, state, tendency):
        from ..util.quantity import Quantity

        return {}, Quantity(np.zeros(()), (), "")
