"""Multi-band longwave radiative transfer in JAX.

Plays the role of the reference's `radlw/radlw_main.py` (`RadLWClass`,
3,717 LoC, 16 bands / 140 g-points; SURVEY 2.2).  Design:

- per-band Planck emission uses exact band fractions of sigma*T^4,
  precomputed at import time by numerically integrating the Planck
  function over each band's wavenumber limits on a temperature grid
  (a 64-entry table interpolated with jnp.interp — tiny, stays in
  cache; contrast with RRTMG's 59-temperature 140-g-point
  tables);
- absorption-approximation transfer (no LW scattering, as in RRTMG):
  one downward and one upward `lax.scan` over levels with all bands
  and columns batched, diffusivity factor 1.66;
- gas optics from radgases.py band coefficients, cloud absorption from
  radclouds.cloud_optics_lw.

Validated in tests/test_radiation.py: isothermal-atmosphere OLR limit,
surface balance, cooling-rate magnitudes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CP_AIR, GRAV
from . import radclouds, radgases

STEFAN_BOLTZMANN = 5.670374419e-8
DIFFUSIVITY = 1.66

# --- Planck band-fraction tables (computed once at import) ------------
_PLANCK_T_GRID = np.linspace(120.0, 360.0, 64)


def _band_fractions(limits_cm1, t_grid):
    """Fraction of sigma*T^4 emitted in [v1,v2] (cm^-1) at each T."""
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    fracs = np.zeros((len(limits_cm1), len(t_grid)))
    for i, (v1, v2) in enumerate(limits_cm1):
        v = np.linspace(v1, v2, 256) * 100.0  # -> m^-1
        for j, t in enumerate(t_grid):
            x = h * c * v / (kb * t)
            b = v ** 3 / np.expm1(np.minimum(x, 500.0))
            trapezoid = getattr(np, "trapezoid", np.trapz)
            integral = trapezoid(b, v) * (2 * np.pi * h * c * c)
            fracs[i, j] = integral / (STEFAN_BOLTZMANN * t ** 4)
    return fracs


_LW_BAND_FRAC = _band_fractions(radgases.LW_BAND_LIMITS, _PLANCK_T_GRID)


def planck_band_flux(temp):
    """pi*B integrated over each band: [band, ...temp.shape] W/m^2."""
    t_grid = jnp.asarray(_PLANCK_T_GRID)
    sig_t4 = STEFAN_BOLTZMANN * temp ** 4
    flat = temp.reshape(-1)
    fracs = jnp.stack(
        [
            jnp.interp(flat, t_grid, jnp.asarray(_LW_BAND_FRAC[b]))
            for b in range(radgases.NBANDS_LW)
        ]
    ).reshape((radgases.NBANDS_LW,) + temp.shape)
    return fracs * sig_t4[None]


@dataclasses.dataclass
class RadLWClass:
    """LW band solver facade (radlw_main.py:RadLWClass role)."""

    gases: radgases.GasConcentrations = dataclasses.field(
        default_factory=radgases.GasConcentrations
    )

    def optical_depth(self, p_lay, delp, sphum, o3mmr, ql, qi,
                      cldfrac):
        """(tau_gas, tau_cld): the gas part takes the correlated-k
        multipliers; clouds are grey within each band."""
        u_h2o, u_co2, u_o3 = radgases.absorber_paths(
            delp, sphum, o3mmr, self.gases.co2_mass_mixing_ratio()
        )
        nb = radgases.NBANDS_LW
        bshape = (nb,) + (1,) * delp.ndim

        def bc(x):
            return jnp.asarray(x).reshape(bshape)

        # self-continuum scaling ~ vapor partial pressure
        e_vap = sphum * p_lay / 0.622
        tau = (
            bc(radgases.LW_K_H2O) * u_h2o
            + bc(radgases.LW_K_CO2) * u_co2
            + bc(radgases.LW_K_O3) * u_o3
            + bc(radgases.LW_K_SELF) * u_h2o * (e_vap / 1000.0)
        )
        cwp_l, cwp_i = radclouds.condensate_paths(delp, ql, qi)
        eff = jnp.clip(cldfrac, 0.0, 1.0)
        tau_cld = radclouds.cloud_optics_lw(cwp_l * eff, cwp_i * eff)
        return tau, tau_cld[None]

    def __call__(self, p_lay, delp, temp, sphum, o3mmr, ql, qi,
                 cldfrac, tsfc, sfc_emissivity=0.98):
        """All-sky LW fluxes and heating.

        Column fields [nz, ...cols] (level 0 = model top); tsfc
        [...cols].  Returns interface fluxes [nz+1, ...] and heating
        rate [nz, ...] in K/s.
        """
        tau_gas, tau_cld = self.optical_depth(
            p_lay, delp, sphum, o3mmr, ql, qi, cldfrac
        )
        src = planck_band_flux(temp)  # [band, nz, ...]
        b_sfc = planck_band_flux(tsfc)  # [band, ...]
        zero = jnp.zeros(src.shape[:1] + src.shape[2:], src.dtype)

        def per_gpoint(mult):
            # correlated-k quadrature point on the GAS absorption
            tau = tau_gas * mult + tau_cld
            trans = jnp.exp(-jnp.minimum(DIFFUSIVITY * tau, 50.0))

            def down_step(fdn, inp):
                t, b = inp
                new = fdn * t + b * (1.0 - t)
                return new, new

            # scan over the level axis (axis 1 of [band, nz, ...])
            _, fdn_body = jax.lax.scan(
                down_step, zero,
                (jnp.moveaxis(trans, 1, 0), jnp.moveaxis(src, 1, 0)),
            )
            flux_dn = jnp.concatenate(
                [zero[None], fdn_body], axis=0
            )  # [nz+1, band, ...]

            fup_sfc = (
                sfc_emissivity * b_sfc
                + (1.0 - sfc_emissivity) * flux_dn[-1]
            )

            def up_step(fup, inp):
                t, b = inp
                new = fup * t + b * (1.0 - t)
                return new, new

            _, fup_body = jax.lax.scan(
                up_step, fup_sfc,
                (jnp.moveaxis(trans, 1, 0)[::-1],
                 jnp.moveaxis(src, 1, 0)[::-1]),
            )
            flux_up = jnp.concatenate(
                [fup_sfc[None], fup_body], axis=0
            )[::-1]  # [nz+1, band, ...]
            return flux_dn, flux_up

        fd_g, fu_g = jax.lax.map(
            per_gpoint,
            jnp.asarray(radgases.LW_GPT_MULT, delp.dtype),
        )
        w_gpt = jnp.asarray(radgases.LW_GPT_W, delp.dtype).reshape(
            (-1,) + (1,) * (fd_g.ndim - 1)
        )
        flux_dn_tot = (w_gpt * fd_g).sum(axis=(0, 2))
        flux_up_tot = (w_gpt * fu_g).sum(axis=(0, 2))
        net = flux_up_tot - flux_dn_tot  # upward positive
        heating = -(net[:-1] - net[1:]) * GRAV / (CP_AIR * delp)
        return {
            "flux_dn": flux_dn_tot,
            "flux_up": flux_up_tot,
            "heating_rate": heating,
            "sfc_dn": flux_dn_tot[-1],
            "sfc_up": flux_up_tot[-1],
            "olr": flux_up_tot[0],
        }
