"""Orographic gravity-wave drag (GFS gwdps role, reduced order).

The reference's suite steps the GFS orographic GWD inside the Fortran
physics driver (SURVEY 2.1 "GFS physics suite"; the scheme itself
lives in the empty fv3gfs-fortran submodule).  This is a JAX
McFarlane (1987)-style single-wave scheme:

* low-level wave stress from the subgrid orography standard deviation:
  tau_0 = rho_s * k * N_s * |U_s| * h_eff^2, with h_eff capped by the
  Froude criterion (N h / U <= Fc);
* the stress propagates upward unchanged until the wave saturates
  (local Froude/saturation criterion via a minimum-stress profile
  tau_k <= tau_sat(k) = rho k N |U|^3-ish closure), where the excess
  deposits as a decelerating force along the surface-wind direction;
* momentum is conserved: the column-integrated force equals the
  surface stress minus the stress radiated out the model top.

All jnp, fields [..., nz, ...] with the level axis at ``axis=1``,
jitted into the physics step.  Tendencies act on A-grid winds.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..constants import CP_AIR, GRAV, RDGAS

KAPPA = RDGAS / CP_AIR


@dataclasses.dataclass(frozen=True)
class GWDConfig:
    k_wave: float = 2.0e-5     # horizontal wavenumber (1/m), ~300 km
    froude_crit: float = 1.0   # h_eff cap: N h / U <= Fc
    efficiency: float = 0.35   # fraction of linear stress realized
    u_min: float = 1.0         # floor on |U| (m/s)


def brunt_vaisala(t, p, axis=1):
    """Dry N^2 on layer midpoints from theta differences."""
    theta = t * (1.0e5 / p) ** KAPPA
    dlth = jnp.diff(jnp.log(theta), axis=axis)
    # layer spacing from hydrostatics: |dz| = (R Tbar / g) dlnp
    # (positive: p increases downward so dlnp > 0 along k)
    dz = (RDGAS * 0.5 * (
        jnp.take(t, jnp.arange(t.shape[axis] - 1), axis=axis)
        + jnp.take(t, jnp.arange(1, t.shape[axis]), axis=axis)
    ) / GRAV) * jnp.diff(jnp.log(p), axis=axis)
    # k increases downward: theta decreasing with k (dlth < 0) is
    # stable, N^2 = -g dln(theta)/dz > 0
    n2 = -GRAV * dlth / jnp.maximum(dz, 1.0)
    return jnp.clip(n2, 1.0e-8, 1.0e-3)


def gravity_wave_drag(u, v, t, p, delp, h_std, dt,
                      cfg: GWDConfig = GWDConfig()):
    """A-grid wind increments (du, dv) over dt + diagnostics.

    u, v, t, p, delp: [.., nz, ..] (k increases downward); h_std
    subgrid orography std-dev [.., ..] (no level axis).
    """
    nz = u.shape[1]
    # surface-layer (lowest-level) quantities
    us, vs = u[:, -1], v[:, -1]
    spd_s = jnp.sqrt(us ** 2 + vs ** 2)
    spd_s_c = jnp.maximum(spd_s, cfg.u_min)
    ts = t[:, -1]
    ps = p[:, -1]
    rho_s = ps / (RDGAS * ts)
    n2 = brunt_vaisala(t, p)
    n_s = jnp.sqrt(n2[:, -1])
    # Froude-capped effective mountain height
    h_eff = jnp.minimum(
        h_std, cfg.froude_crit * spd_s_c / jnp.maximum(n_s, 1e-4)
    )
    tau0 = (
        cfg.efficiency * rho_s * cfg.k_wave * n_s * spd_s_c
        * h_eff ** 2
    )
    # unit vector of the surface wind (wave-parallel drag)
    ex = us / spd_s_c
    ey = vs / spd_s_c

    # saturation stress profile: tau_sat_k = eff*rho*k*N*Up^2*Fc^2/N
    # with Up the wind component along the surface-wind direction
    up = u * ex[:, None] + v * ey[:, None]
    up = jnp.maximum(up, cfg.u_min * 0.1)
    rho = p / (RDGAS * t)
    n_mid = jnp.sqrt(
        jnp.concatenate([n2[:, :1], n2], axis=1)
    )
    # McFarlane saturation closure consistent with tau0's dimensions:
    # tau_sat = eff * rho * k * Fc^2 * Up^3 / N  (Pa)
    tau_sat = (
        cfg.efficiency * rho * cfg.k_wave * cfg.froude_crit ** 2
        * up ** 3 / jnp.maximum(n_mid, 1e-4)
    )
    # Interface stresses, bottom-up: the wave carries tau0 from the
    # surface and cannot exceed the local saturation stress anywhere
    # below, so the stress at the TOP of layer k is
    # min(tau0, min_{j>=k} tau_sat[j]) — a running minimum from the
    # bottom.  The per-layer convergence tau_bot - tau_top >= 0
    # decelerates the along-wind component, and the column sum
    # telescopes to tau0 - tau_top_of_model (exact momentum
    # bookkeeping, asserted in tests/test_gwd_shalconv.py).
    import jax as _jax

    cfb = _jax.lax.cummin(tau_sat[:, ::-1], axis=1)[:, ::-1]
    tau_top = jnp.minimum(tau0[:, None], cfb)  # [.., nz, ..]
    tau_bot = jnp.concatenate(
        [tau_top[:, 1:], tau0[:, None]], axis=1
    )
    dtau = tau_bot - tau_top  # stress convergence per layer (>= 0)
    accel = GRAV * dtau / delp  # m/s^2 decelerating along (ex, ey)
    du = -accel * ex[:, None] * dt
    dv = -accel * ey[:, None] * dt
    # never reverse the along-wind component within one step
    limit = jnp.abs(up) / jnp.maximum(
        jnp.sqrt(du ** 2 + dv ** 2), 1e-10
    )
    scale = jnp.minimum(1.0, limit)
    du = du * scale
    dv = dv * scale
    diags = {
        "gwd_surface_stress": tau0,
        "gwd_top_stress": tau_top[:, 0],
        "gwd_column_drag": (
            jnp.sqrt(du ** 2 + dv ** 2) * delp / GRAV
        ).sum(axis=1) / dt,
    }
    return du, dv, diags


def shallow_convection(t, qv, p, delp, dt, depth_pa: float = 2.5e4,
                       tau: float = 3600.0, cape_min: float = 0.0):
    """Non-precipitating shallow convective mixing (GFS shalcnv role,
    reduced order): where the boundary layer is conditionally unstable
    but deep convection has not fired, relax the lowest ~250 hPa
    toward a well-mixed profile of moist enthalpy, conserving column
    enthalpy and water exactly and transporting moisture upward.

    Returns (t_new, qv_new, diags).
    """
    from ..constants import LATENT_HEAT_VAPORIZATION as LV

    ps = p[:, -1:]
    in_layer = (ps - p) < depth_pa  # mask [.., nz, ..]
    w = jnp.where(in_layer, delp, 0.0)
    wsum = jnp.maximum(w.sum(axis=1, keepdims=True), 1.0)
    # moist STATIC energy h = cp*T + Lv*qv + g*z: the gz term makes a
    # subadiabatic dry column stable (dry static energy increases with
    # height) while a warm/moist surface layer still triggers --
    # z from hydrostatic integration (surface = 0)
    dz = (RDGAS * t / GRAV) * delp / p
    below = jnp.cumsum(dz[:, ::-1], axis=1)[:, ::-1] - dz
    z_mid = below + 0.5 * dz
    h = CP_AIR * t + LV * qv + GRAV * z_mid
    h_mean = (h * w).sum(axis=1, keepdims=True) / wsum
    unstable = (h[:, -1:] - h_mean) > cape_min
    frac = (1.0 - jnp.exp(-dt / tau)) * unstable
    # relax MSE and moisture toward their mass-weighted means; gz is
    # fixed per level, so column cp*T + Lv*qv is conserved exactly
    qv_mean = (qv * w).sum(axis=1, keepdims=True) / wsum
    dq = jnp.where(in_layer, frac * (qv_mean - qv), 0.0)
    dh = jnp.where(in_layer, frac * (h_mean - h), 0.0)
    qv_new = qv + dq
    # temperature takes the MSE change minus the latent part
    t_new = t + (dh - LV * dq) / CP_AIR
    diags = {
        "shallow_convection_active": jnp.squeeze(
            unstable.astype(t.dtype), axis=1
        ),
    }
    return t_new, qv_new, diags
