"""Multi-band shortwave radiative transfer in JAX.

Plays the role of the reference's `radsw/radsw_main.py` (`RadSWClass`,
2,842 LoC, 14 bands / 112 g-points; SURVEY 2.2).  Design:

- optical properties are [band, nz, ...column] arrays built by pure
  elementwise expressions (radgases/radclouds) — XLA fuses them;
- each layer gets delta-Eddington-scaled two-stream reflectance and
  transmittance (direct + diffuse), then layers are combined with the
  adding method via `lax.scan` over the (static) level dimension with
  all bands and columns batched — each scan step is a fat elementwise
  block over [band, cols], no host control flow;
- the 14 RRTMG_SW bands (radgases.SW_BAND_LIMITS_CM1) each carry a
  small correlated-k quadrature (radgases.SW_GPT_*): gas optical depth
  is evaluated at NGPT_SW multipliers per band with `lax.map`
  (sequential, memory-bounded) and the fluxes g-weight-summed —
  the curve-of-growth role of RRTMG's 112 g-points;
- spectral surface albedo: direct/diffuse x UV-VIS/NIR components
  (radsurface.surface_albedo_spectral) selected per band.

Validated in tests/test_radiation.py: conservation (TOA net = column
absorption + surface net), no-atmosphere limit, heating-rate ranges.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..constants import CP_AIR, GRAV
from . import radclouds, radgases

SOLAR_CONSTANT = 1361.0


def delta_scale(tau, w, g):
    """Delta-Eddington scaling: fold the forward-scattering peak f=g^2
    into the direct beam (Joseph, Wiscombe & Weinman 1976)."""
    f = g * g
    tau_s = (1.0 - w * f) * tau
    w_s = (1.0 - f) * w / jnp.maximum(1.0 - w * f, 1e-12)
    g_s = (g - f) / jnp.maximum(1.0 - f, 1e-12)
    return tau_s, w_s, g_s


def two_stream_layer(tau, w, g, mu0):
    """Two-stream (Eddington) layer reflectance/transmittance.

    Returns (rdif, tdif, rdir, tdir_dif, tdir_dir):
      rdif/tdif   — reflect/transmit for diffuse incidence
                    (Meador & Weaver 1980 Eddington coefficients);
      rdir        — upward diffuse from unit direct incidence;
      tdir_dif    — downward diffuse exiting the layer bottom from
                    unit direct incidence;
      tdir_dir    — surviving direct beam exp(-tau/mu0).

    The direct-beam source uses the energy-conserving single-scatter
    split: of the scattered fraction w*(1-t0), g3 goes up and g4 down
    (multiple scattering BETWEEN layers is recovered by the adding
    method), so rdir + tdir_dif + absorbed + tdir_dir == 1 exactly.
    """
    w = jnp.clip(w, 1e-6, 1.0 - 1e-6)
    g1 = 0.25 * (7.0 - w * (4.0 + 3.0 * g))
    g2 = -0.25 * (1.0 - w * (4.0 - 3.0 * g))
    g3 = 0.25 * (2.0 - 3.0 * g * mu0)
    g4 = 1.0 - g3
    lam = jnp.sqrt(jnp.maximum(g1 * g1 - g2 * g2, 1e-12))
    e = jnp.exp(-jnp.minimum(lam * tau, 50.0))
    e2 = e * e
    denom = lam + g1 + (lam - g1) * e2
    rdif = g2 * (1.0 - e2) / denom
    tdif = 2.0 * lam * e / denom

    mu0 = jnp.maximum(mu0, 1e-3)
    t0 = jnp.exp(-jnp.minimum(tau / mu0, 50.0))
    scat = w * (1.0 - t0)
    rdir = scat * g3
    tdir_dif = scat * g4
    return rdif, tdif, rdir, tdir_dif, t0


def adding_method(rdif, tdif, rdir, tdir_dif, tdir_dir, alb_dir,
                  alb_dif, mu0, toa_flux):
    """Combine layers with the adding method; fluxes at all interfaces.

    Layer arrays are [nz, ...cols]; alb_*/toa_flux are [...cols].
    Returns (flux_dn, flux_up) at [nz+1, ...] interfaces, in units of
    toa_flux (normal-incidence irradiance x mu0 applied by caller).

    Pass 1 (surface up): stack albedo below each interface for diffuse
    (a_dif) and direct (a_dir) incidence:
        a_dir' = rdir + tdif*(t0*a_dir + tdir_dif*a_dif)/(1-rdif*a_dif)
        a_dif' = rdif + tdif^2*a_dif/(1-rdif*a_dif)
    Pass 2 (TOA down): propagate (diffuse-down, direct) through each
    layer with interreflection against the stack below.
    """

    def up_step(carry, layer):
        a_dif, a_dir = carry
        rd, td, rr, tdf, t0 = layer
        denom = 1.0 / jnp.maximum(1.0 - rd * a_dif, 1e-12)
        new_adir = rr + td * denom * (t0 * a_dir + tdf * a_dif)
        new_adif = rd + td * td * a_dif * denom
        return (new_adif, new_adir), (a_dif, a_dir)

    layers_rev = (
        rdif[::-1], tdif[::-1], rdir[::-1], tdir_dif[::-1],
        tdir_dir[::-1],
    )
    (a_dif_top, a_dir_top), below = jax.lax.scan(
        up_step, (alb_dif, alb_dir), layers_rev
    )
    # albedo of the stack below interface k+1, for k = 0..nz-1
    adif_b = below[0][::-1]
    adir_b = below[1][::-1]

    def down_step(carry, inp):
        fdn_dif, fdir = carry
        rd, td, rr, tdf, t0, ab_dif, ab_dir = inp
        denom = 1.0 / jnp.maximum(1.0 - rd * ab_dif, 1e-12)
        new_fdir = fdir * t0
        src = fdir * tdf + fdn_dif * td
        new_fdn = (src + new_fdir * ab_dir * rd) * denom
        fup = new_fdir * ab_dir + new_fdn * ab_dif
        return (new_fdn, new_fdir), (new_fdn, new_fdir, fup)

    init = (jnp.zeros_like(toa_flux), toa_flux)
    _, (fdn_dif, fdir, fup_below) = jax.lax.scan(
        down_step,
        init,
        (rdif, tdif, rdir, tdir_dif, tdir_dir, adif_b, adir_b),
    )
    flux_dn_dif = jnp.concatenate(
        [jnp.zeros_like(toa_flux)[None], fdn_dif], axis=0
    )
    flux_dir = jnp.concatenate([toa_flux[None], fdir], axis=0)
    fup_top = toa_flux * a_dir_top
    flux_up = jnp.concatenate([fup_top[None], fup_below], axis=0)
    flux_dn = (flux_dn_dif + flux_dir) * mu0[None]
    return flux_dn, flux_up * mu0[None]


@dataclasses.dataclass
class RadSWClass:
    """SW band solver facade (radsw_main.py:RadSWClass role)."""

    aerosols: radclouds.AerosolClimatology = dataclasses.field(
        default_factory=radclouds.AerosolClimatology
    )
    gases: radgases.GasConcentrations = dataclasses.field(
        default_factory=radgases.GasConcentrations
    )

    def __call__(self, mu0, p_lay, delp, sphum, o3mmr, ql, qi, cldfrac,
                 sfc_albedo, solcon=SOLAR_CONSTANT, aod550=None):
        """All-sky SW fluxes and heating.

        Shapes: column fields [nz, ...cols]; mu0/sfc_albedo [...cols].
        Returns dict of interface fluxes ([nz+1, ...]) and heating
        rate (K/s, [nz, ...]).
        """
        u_h2o, u_co2, u_o3 = radgases.absorber_paths(
            delp, sphum, o3mmr, self.gases.co2_mass_mixing_ratio()
        )
        nb = radgases.NBANDS_SW
        bshape = (nb,) + (1,) * delp.ndim

        def bc(x):
            return jnp.asarray(x).reshape(bshape)

        tau_gas = (
            bc(radgases.SW_K_H2O) * u_h2o
            + bc(radgases.SW_K_O3) * u_o3
            + bc(radgases.SW_K_CO2) * u_co2
        )
        tau_ray = bc(radgases.SW_TAU_RAYLEIGH) * (delp / 101325.0)
        tau_aer, w_aer, g_aer = self.aerosols.sw_optics(
            p_lay, delp, aod550=aod550
        )
        cwp_l, cwp_i = radclouds.condensate_paths(delp, ql, qi)
        # effective (random-overlap) cloud optics: tau scaled by
        # cldfrac^(3/2) — the standard effective-optical-depth closure
        eff = jnp.clip(cldfrac, 0.0, 1.0) ** 1.5
        tau_c, w_c, g_c = radclouds.cloud_optics_sw(
            cwp_l * eff, cwp_i * eff
        )
        # grey (g-point-independent) scattering components
        tau_grey = tau_ray + tau_aer + tau_c[None]
        wtau = tau_ray + tau_aer * w_aer + (w_c * tau_c)[None]
        gwtau = tau_aer * w_aer * g_aer + (g_c * w_c * tau_c)[None]
        g_eff = gwtau / jnp.maximum(wtau, 1e-12)

        mu0c = jnp.maximum(mu0, 1e-3)
        toa = solcon * jnp.asarray(radgases.SW_BAND_FRAC).reshape(
            (nb,) + (1,) * (delp.ndim - 1)
        ) * jnp.ones_like(mu0c)[None]
        # spectral surface albedo: a dict selects the UV-VIS vs NIR
        # component per band (setalb contract); a scalar/array is the
        # legacy broadband form
        uvvis = jnp.asarray(radgases.SW_BAND_UVVIS).reshape(
            (nb,) + (1,) * (delp.ndim - 1)
        )
        if isinstance(sfc_albedo, dict):
            alb_dir = jnp.where(
                uvvis, sfc_albedo["uvvis_dir"][None],
                sfc_albedo["nir_dir"][None],
            ) * jnp.ones_like(toa)
            alb_dif = jnp.where(
                uvvis, sfc_albedo["uvvis_dif"][None],
                sfc_albedo["nir_dif"][None],
            ) * jnp.ones_like(toa)
        else:
            alb_dir = jnp.broadcast_to(sfc_albedo, toa.shape)
            alb_dif = alb_dir

        def solve_band(args):
            rd, td, rr, tdf, tt0, tb, abr, abf = args
            # adding_method signature: (..., alb_dir, alb_dif, ...)
            return adding_method(
                rd, td, rr, tdf, tt0, abr, abf, mu0c, tb
            )

        def per_gpoint(mult):
            # correlated-k quadrature point: scale the GAS absorption
            tau_g = tau_gas * mult + tau_grey
            w_g = jnp.clip(
                wtau / jnp.maximum(tau_g, 1e-12), 0.0, 1.0 - 1e-6
            )
            tau_s, w_s, g_s = delta_scale(tau_g, w_g, g_eff)
            rdif, tdif, rdir, tdir_dif, t0 = two_stream_layer(
                tau_s, w_s, g_s, mu0c
            )
            return jax.vmap(solve_band)(
                (rdif, tdif, rdir, tdir_dif, t0, toa, alb_dir,
                 alb_dif)
            )

        # sequential over quadrature points (memory-bounded)
        fd_g, fu_g = jax.lax.map(
            per_gpoint, jnp.asarray(radgases.SW_GPT_MULT, delp.dtype)
        )
        w_gpt = jnp.asarray(radgases.SW_GPT_W, delp.dtype).reshape(
            (-1,) + (1,) * (fd_g.ndim - 1)
        )
        flux_dn = (w_gpt * fd_g).sum(axis=(0, 1))
        flux_up = (w_gpt * fu_g).sum(axis=(0, 1))
        day = (mu0 > 1e-3).astype(flux_dn.dtype)
        flux_dn = flux_dn * day[None]
        flux_up = flux_up * day[None]
        net = flux_dn - flux_up
        heating = (net[:-1] - net[1:]) * GRAV / (CP_AIR * delp)
        return {
            "flux_dn": flux_dn,
            "flux_up": flux_up,
            "heating_rate": heating,
            "sfc_dn": flux_dn[-1],
            "sfc_net": net[-1],
            "toa_dn": flux_dn[0],
            "toa_up": flux_up[0],
        }
