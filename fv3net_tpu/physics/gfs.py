"""GFS-style column physics suite, in pure JAX (jittable).

The reference steps a Fortran GFS physics suite through the wrapper
phases (SURVEY 2.1: radiation / PBL / convection / Zhao-Carr
microphysics; runtime/loop.py:470-514).  This module rebuilds that
suite as fused on-device column physics:

  * surface exchange  -- bulk aerodynamic fluxes with a Louis (1979)
    stability correction (role of GFS ``sfc_diff``/``sfc_ocean``)
  * PBL vertical diffusion -- bulk-Richardson boundary-layer height, a
    K-profile eddy diffusivity, and a backward-Euler implicit vertical
    solve per column (role of GFS ``moninedmf``); the tridiagonal
    Thomas solve is a `lax.scan` over levels, batched over all
    6*n*n columns so every scan step is one [6, n, n] array op
  * convection -- a Betts-Miller relaxed adjustment toward a
    lifted-parcel moist adiabat with column enthalpy conservation
    (role of GFS SAS/samf deep+shallow convection)
  * Zhao-Carr microphysics -- grid-scale condensation (``gscond``) and
    precipitation production with re-evaporation of falling rain
    (``precpd``), the exact process pair the reference's online
    emulators substitute via call_py_fort
    (external/emulation/README.md:9-24, zhao_carr.py state names)

Everything is shape-static [6, nz, n, n] float32 (level index 0 = top,
FV3 convention), so the whole suite fuses into a handful of XLA kernels
between the dynamics steps.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..constants import (
    CP_AIR,
    GRAV,
    LATENT_HEAT_VAPORIZATION,
    RDGAS,
    RVGAS,
)

ZVIR = RVGAS / RDGAS - 1.0
KARMAN = 0.4
LV_CP = LATENT_HEAT_VAPORIZATION / CP_AIR
EPS = RDGAS / RVGAS


@dataclasses.dataclass(frozen=True)
class GFSPhysicsConfig:
    """Tunables of the suite (GFS namelist analogue)."""

    z0: float = 1.0e-4          # roughness length (m), ocean-like
    ri_crit: float = 0.25       # critical bulk Richardson number
    k_background: float = 0.1   # free-atmosphere diffusivity (m^2/s)
    k_max: float = 800.0        # diffusivity cap (m^2/s)
    tau_bm: float = 7200.0      # Betts-Miller relaxation time (s)
    convection_scheme: str = "betts_miller"  # or "mass_flux" (SAS-like)
    rh_bm: float = 0.8          # BM reference relative humidity
    tau_autoconv: float = 1800.0  # cloud->rain autoconversion time (s)
    evap_rain: float = 2.0e-5   # rain re-evaporation efficiency
    do_convection: bool = True
    do_shallow_convection: bool = True  # GFS shalcnv role (gwd.py)
    do_gwd: bool = True  # orographic gravity-wave drag (gwd.py);
    #                      active only when h_std orography is passed
    do_pbl: bool = True
    do_surface: bool = True
    do_microphysics: bool = True
    # "zhao_carr" (gscond+precpd, the default suite) or "gfdl"
    # (6-category bulk scheme, physics/gfdl_mp.py -- the reference
    # namelist's GFDL cloud microphysics role)
    microphysics_scheme: str = "zhao_carr"


# --------------------------------------------------------------------------
# thermodynamic helpers (float32-safe)
# --------------------------------------------------------------------------


def esat(t):
    """Bolton saturation vapor pressure over liquid (Pa)."""
    tc = t - 273.15
    return 611.2 * jnp.exp(17.67 * tc / (tc + 243.5))


def qsat(t, p):
    es = jnp.minimum(esat(t), 0.99 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def dqsat_dt(t, p):
    qs = qsat(t, p)
    return qs * 17.67 * 243.5 / (t - 273.15 + 243.5) ** 2


def pressure_fields(delp, ptop):
    """Interface and layer-mean pressures from delp [.., nz, ..]."""
    pe = ptop + jnp.concatenate(
        [jnp.zeros_like(delp[:, :1]), jnp.cumsum(delp, axis=1)], axis=1
    )
    p = 0.5 * (pe[:, 1:] + pe[:, :-1])
    return pe, p


def layer_geometry(t, q, delp, pe):
    """Hydrostatic layer thickness dz and midpoint height above the
    surface (z=0 at the ground)."""
    tv = t * (1.0 + ZVIR * q)
    dlnp = jnp.log(pe[:, 1:] / jnp.maximum(pe[:, :-1], 1.0))
    dz = RDGAS * tv / GRAV * dlnp  # positive, top->bottom ordering
    # height of layer midpoints: integrate from surface (last level) up
    below = jnp.cumsum(dz[:, ::-1], axis=1)[:, ::-1] - dz
    z_mid = below + 0.5 * dz
    return dz, z_mid


# --------------------------------------------------------------------------
# surface layer (sfc_diff / sfc_ocean role)
# --------------------------------------------------------------------------


def surface_exchange(t1, q1, u1, v1, p_sfc, p1, z1, tsfc, cfg):
    """Bulk exchange coefficients with Louis (1979) stability functions.

    Returns (cdm, cdh) = C_d |U|, C_h |U|  [m/s] plus friction velocity
    and the surface saturation humidity.
    """
    wind = jnp.sqrt(u1 ** 2 + v1 ** 2 + 1.0e-3)
    th1 = t1 * (1.0e5 / p1) ** (RDGAS / CP_AIR)
    qs_sfc = qsat(tsfc, p_sfc)
    thv1 = th1 * (1.0 + ZVIR * q1)
    thvs = tsfc * (1.0e5 / p_sfc) ** (RDGAS / CP_AIR) * (
        1.0 + ZVIR * qs_sfc
    )
    rib = GRAV * z1 * (thv1 - thvs) / (thvs * wind ** 2)
    cn = (KARMAN / jnp.log(z1 / cfg.z0)) ** 2
    # Louis stability functions
    b, c_, d = 5.0, 5.0, 5.0
    unstable = cn * (
        1.0
        - 2.0 * b * rib
        / (1.0 + 3.0 * b * c_ * cn * jnp.sqrt(jnp.abs(rib) * z1 / cfg.z0))
    )
    stable = cn / (1.0 + 2.0 * b * rib / jnp.sqrt(1.0 + d * rib))
    cd = jnp.where(rib < 0.0, unstable, stable)
    cd = jnp.maximum(cd, 1.0e-5)
    cdm = cd * wind
    cdh = cd * wind  # equal heat/momentum transfer in this suite
    ustar = jnp.sqrt(cd) * wind
    return cdm, cdh, ustar, qs_sfc, rib


# --------------------------------------------------------------------------
# PBL: K-profile + implicit vertical diffusion (moninedmf role)
# --------------------------------------------------------------------------


def tridiagonal_solve(a, b, c, d):
    """Batched Thomas algorithm along axis 1.

    Solves tridiag(a, b, c) x = d where a is the sub-diagonal (a[:,0]
    ignored) and c the super-diagonal (c[:,-1] ignored).  Sequential in
    nz only; every scan step is a full [6, n, n] vector op.
    """

    def fwd(carry, x):
        cp_prev, dp_prev = carry
        ak, bk, ck, dk = x
        denom = bk - ak * cp_prev
        cp = ck / denom
        dp = (dk - ak * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zeros = jnp.zeros_like(d[:, 0])
    swap = lambda arr: jnp.swapaxes(arr, 0, 1)
    (_, _), (cp, dp) = jax.lax.scan(
        fwd, (zeros, zeros), (swap(a), swap(b), swap(c), swap(d))
    )

    def back(x_next, x):
        cpk, dpk = x
        xk = dpk - cpk * x_next
        return xk, xk

    _, x_rev = jax.lax.scan(back, zeros, (cp[::-1], dp[::-1]))
    return swap(x_rev[::-1])


def pbl_height(thv, z_mid, u, v, cfg):
    """Boundary-layer height: lowest level where the bulk Richardson
    number from the surface layer exceeds ri_crit."""
    thv1 = thv[:, -1:]
    du = u - u[:, -1:]
    dv = v - v[:, -1:]
    rib = (
        GRAV
        * (z_mid - z_mid[:, -1:])
        * (thv - thv1)
        / (thv1 * (du ** 2 + dv ** 2 + 0.1))
    )
    inside = rib < cfg.ri_crit  # True inside the PBL (from below)
    # scan from the bottom: h = highest contiguous z with ri < crit
    nz = thv.shape[1]
    contig = jnp.cumprod(inside[:, ::-1], axis=1)[:, ::-1]
    h = jnp.max(jnp.where(contig > 0, z_mid, 0.0), axis=1)
    return jnp.maximum(h, z_mid[:, -1])


def k_profile(z_if, h, ustar, cfg):
    """K-profile eddy diffusivity on interior interfaces
    (Troen-Mahrt shape kappa*u*z(1-z/h)^2)."""
    zr = jnp.clip(z_if / h[:, None], 0.0, 1.0)
    k = KARMAN * ustar[:, None] * z_if * (1.0 - zr) ** 2
    k = jnp.clip(k, cfg.k_background, cfg.k_max)
    return k


def diffuse_column(x, mass, g_if, dt, sfc_g, x_sfc):
    """Implicit diffusion: mass_k (x'_k - x_k)/dt = F_{k-1} - F_k with
    F_k = g_if_k (x'_{k+1} - x'_k) downward-positive between layers k
    and k+1, and surface flux F_sfc = sfc_g (x_sfc - x'_{nz-1}).

    mass [kg/m^2] per layer; g_if [kg/m^2/s] interface conductance
    (rho K / dz); sfc_g [kg/m^2/s].
    """
    nz = x.shape[1]
    gi = g_if * dt
    gs = sfc_g * dt
    zeros = jnp.zeros_like(x[:, :1])
    g_up = jnp.concatenate([zeros, gi], axis=1)      # above layer k
    g_dn = jnp.concatenate([gi, zeros], axis=1)      # below layer k
    a = -g_up
    c = -g_dn
    b = mass + g_up + g_dn
    d = mass * x
    # implicit surface exchange adds to the diagonal + rhs of layer nz-1
    b = b.at[:, -1].add(gs[:, 0] if gs.ndim == x.ndim else gs)
    d = d.at[:, -1].add((gs[:, 0] if gs.ndim == x.ndim else gs) * x_sfc)
    return tridiagonal_solve(a, b, c, d)


def rho_layer_mass(delp):
    return delp / GRAV


# --------------------------------------------------------------------------
# Betts-Miller convection (SAS role)
# --------------------------------------------------------------------------


def moist_adiabat(t, q, p, p_parcel_level=-1):
    """Lifted-parcel reference profile: lift the lowest-layer parcel
    (pseudo-adiabatically) through the column.

    Returns (t_ref, q_ref, buoyant) where buoyant marks levels below
    the level of neutral buoyancy.  Sequential lax.scan bottom -> top.
    """
    nz = t.shape[1]
    t0 = t[:, -1]
    q0 = q[:, -1]
    th0 = t0 * (1.0e5 / p[:, -1]) ** (RDGAS / CP_AIR)

    def lift(carry, x):
        tp, qp, p_prev = carry
        pk = x
        # dry adiabatic step then saturation adjustment
        t_dry = tp * (pk / p_prev) ** (RDGAS / CP_AIR)
        qs = qsat(t_dry, pk)
        gamma = LV_CP * dqsat_dt(t_dry, pk)
        cond = jnp.maximum(qp - qs, 0.0) / (1.0 + gamma)
        t_new = t_dry + LV_CP * cond
        q_new = qp - cond
        return (t_new, q_new, pk), (t_new, q_new)

    # scan over levels bottom->top (reverse order)
    p_rev = jnp.swapaxes(p[:, ::-1], 0, 1)
    (_, _, _), (t_par_rev, q_par_rev) = jax.lax.scan(
        lift, (t0, q0, p[:, -1]), p_rev
    )
    t_par = jnp.swapaxes(t_par_rev, 0, 1)[:, ::-1]
    q_par = jnp.swapaxes(q_par_rev, 0, 1)[:, ::-1]
    tv_par = t_par * (1.0 + ZVIR * q_par)
    tv_env = t * (1.0 + ZVIR * q)
    buoy = tv_par > tv_env
    # contiguous buoyant region from the bottom
    active = jnp.cumprod(
        jnp.concatenate(
            [jnp.ones_like(buoy[:, -1:]), buoy[:, :-1]], axis=1
        )[:, ::-1],
        axis=1,
    )[:, ::-1].astype(bool)
    return t_par, q_par, active


def betts_miller(t, q, p, delp, dt, cfg):
    """Relaxed convective adjustment (Betts 1986; Frierson 2007
    simplified BM): relax T toward the lifted-parcel moist adiabat and
    q toward rh_bm * qsat(T_ref) over tau_bm, with the T reference
    shifted so column enthalpy is conserved; precipitation is the
    column moisture removed.  Columns whose adjustment would produce
    negative precipitation are left untouched (shallow/non-precipitating
    limit)."""
    t_ref, q_par, active = moist_adiabat(t, q, p)
    q_ref = cfg.rh_bm * qsat(t_ref, p)
    mass = delp / GRAV
    w = jnp.where(active, mass, 0.0)
    wsum = jnp.maximum(w.sum(axis=1, keepdims=True), 1.0e-10)
    # enthalpy-conserving shift of the temperature reference:
    # cp <dT> = Lv <dq>  over active levels
    dT0 = jnp.where(active, t_ref - t, 0.0)
    dq0 = jnp.where(active, q_ref - q, 0.0)
    shift = (
        (w * (dT0 + LV_CP * dq0)).sum(axis=1, keepdims=True) / wsum
    )
    dT = dT0 - shift * active
    dq = dq0
    f = dt / cfg.tau_bm
    precip = -(w * dq * f).sum(axis=1)  # kg/m^2 over dt
    do = (precip > 0.0)[:, None] & active & (
        active.sum(axis=1, keepdims=True) > 1
    )
    t_new = jnp.where(do, t + f * dT, t)
    q_new = jnp.where(do, q + f * dq, q)
    precip = jnp.maximum(precip, 0.0) * (
        do.any(axis=1).astype(t.dtype)
    )
    return t_new, q_new, precip


# --------------------------------------------------------------------------
# Zhao-Carr microphysics (gscond + precpd roles)
# --------------------------------------------------------------------------


def gscond(t, qv, qc, p, dt):
    """Grid-scale condensation/evaporation (Zhao & Carr 1997 gscond
    role): condense supersaturation / evaporate cloud, iterated twice
    with latent-heating feedback."""
    for _ in range(2):
        qs = qsat(t, p)
        gamma = LV_CP * dqsat_dt(t, p)
        excess = (qv - qs) / (1.0 + gamma)
        cond = jnp.maximum(excess, 0.0)
        evap = jnp.where(excess < 0.0, jnp.minimum(qc, -excess), 0.0)
        qv = qv - cond + evap
        qc = qc + cond - evap
        t = t + LV_CP * (cond - evap)
    return t, qv, qc


def precpd(t, qv, qc, p, delp, dt, cfg):
    """Precipitation production + falling-rain re-evaporation (Zhao &
    Carr 1997 precpd role).  Rain forms by autoconversion, falls
    through the column within the step, and partially re-evaporates in
    subsaturated layers; scan runs top -> bottom."""
    mass = delp / GRAV
    rain_src = qc * -jnp.expm1(-dt / cfg.tau_autoconv)
    qc = qc - rain_src

    def fall(flux, x):
        src_k, t_k, qv_k, p_k, m_k = x
        flux = flux + src_k * m_k  # kg/m^2 entering layer from above
        qs = qsat(t_k, p_k)
        subsat = jnp.maximum(qs - qv_k, 0.0)
        gamma = LV_CP * dqsat_dt(t_k, p_k)
        evap = jnp.minimum(
            cfg.evap_rain * dt * subsat / (1.0 + gamma) * jnp.sqrt(
                jnp.maximum(flux, 0.0) + 1.0e-12
            ),
            jnp.minimum(flux / m_k, subsat / (1.0 + gamma)),
        )
        evap = jnp.maximum(evap, 0.0)
        qv_new = qv_k + evap
        t_new = t_k - LV_CP * evap
        flux = flux - evap * m_k
        return flux, (t_new, qv_new)

    swap = lambda arr: jnp.swapaxes(arr, 0, 1)
    flux0 = jnp.zeros_like(t[:, 0])
    precip, (t_new, qv_new) = jax.lax.scan(
        fall,
        flux0,
        (swap(rain_src), swap(t), swap(qv), swap(p), swap(mass)),
    )
    return swap(t_new), swap(qv_new), qc, precip


# --------------------------------------------------------------------------
# the full suite
# --------------------------------------------------------------------------


def _to_agrid(u_d, v_d):
    ua = 0.5 * (u_d[:, :, :-1, :] + u_d[:, :, 1:, :])
    va = 0.5 * (v_d[:, :, :, :-1] + v_d[:, :, :, 1:])
    return ua, va


def _tendency_to_dgrid(du_a, dv_a):
    pad_u = jnp.concatenate(
        [du_a[:, :, :1], 0.5 * (du_a[:, :, 1:] + du_a[:, :, :-1]),
         du_a[:, :, -1:]], axis=2,
    )
    pad_v = jnp.concatenate(
        [dv_a[:, :, :, :1], 0.5 * (dv_a[:, :, :, 1:] + dv_a[:, :, :, :-1]),
         dv_a[:, :, :, -1:]], axis=3,
    )
    return pad_u, pad_v


@functools.partial(jax.jit, static_argnames=("cfg",))
def gfs_physics_step(
    t, qv, qc, u_d, v_d, delp, tsfc, ptop, dt,
    cfg: GFSPhysicsConfig = GFSPhysicsConfig(),
    h_std=None,
    mp_tracers=None,
) -> Tuple[Dict[str, jnp.ndarray], Dict[str, jnp.ndarray]]:
    """One physics step.  Fields [6, nz, n, n] (winds D-grid staggered);
    h_std: optional subgrid-orography std-dev [6, n, n] enabling the
    gravity-wave drag.  mp_tracers: optional (qi, qr, qs, qg)
    prognostic hydrometeors -- with the GFDL scheme these are advected
    dycore tracers carrying falling-precipitation memory between steps
    (the reference's in-dycore GFDL MP tracer set, fv_core_nml
    do_sat_adj + gfdl_cloud_microphys, test_regression.py:133-200);
    when supplied, qc is the CLOUD LIQUID field and the returned state
    carries all six species separately.  Returns
    (new_state, diagnostics)."""
    shape2d = t.shape[:1] + t.shape[2:]
    # flatten horizontal dims so scans see [cols] batches
    nz = t.shape[1]

    pe, p = pressure_fields(delp, ptop)
    dz, z_mid = layer_geometry(t, qv, delp, pe)
    mass = delp / GRAV
    ua, va = _to_agrid(u_d, v_d)

    diags: Dict[str, jnp.ndarray] = {}
    shf = jnp.zeros(shape2d, t.dtype)
    lhf = jnp.zeros(shape2d, t.dtype)
    h_pbl = jnp.zeros(shape2d, t.dtype)

    if cfg.do_surface or cfg.do_pbl:
        cdm, cdh, ustar, qs_sfc, _ = surface_exchange(
            t[:, -1], qv[:, -1], ua[:, -1], va[:, -1],
            pe[:, -1], p[:, -1], z_mid[:, -1], tsfc, cfg,
        )
        rho_sfc = pe[:, -1] / (RDGAS * t[:, -1] * (1 + ZVIR * qv[:, -1]))

    if cfg.do_pbl:
        th = t * (1.0e5 / p) ** (RDGAS / CP_AIR)
        thv = th * (1.0 + ZVIR * qv)
        h = pbl_height(thv, z_mid, ua, va, cfg)
        h_pbl = h
        z_if_int = z_mid[:, :-1] * 0.5 + z_mid[:, 1:] * 0.5
        k_if = k_profile(z_if_int, h, ustar, cfg)
        rho_if = 0.5 * (
            p[:, :-1] / (RDGAS * t[:, :-1])
            + p[:, 1:] / (RDGAS * t[:, 1:])
        )
        dz_if = 0.5 * (dz[:, :-1] + dz[:, 1:])
        g_if = rho_if * k_if / dz_if

        sfc_g_h = rho_sfc * cdh if cfg.do_surface else jnp.zeros(shape2d)
        sfc_g_m = rho_sfc * cdm if cfg.do_surface else jnp.zeros(shape2d)

        # dry static energy (conserved under dry mixing)
        s = CP_AIR * t + GRAV * z_mid
        s_sfc = CP_AIR * tsfc
        s_new = diffuse_column(s, mass, g_if, dt, sfc_g_h, s_sfc)
        qv_new = diffuse_column(qv, mass, g_if, dt, sfc_g_h, qs_sfc)
        ua_new = diffuse_column(ua, mass, g_if, dt, sfc_g_m,
                                jnp.zeros(shape2d, t.dtype))
        va_new = diffuse_column(va, mass, g_if, dt, sfc_g_m,
                                jnp.zeros(shape2d, t.dtype))
        shf = sfc_g_h * (s_sfc - s_new[:, -1])
        lhf = (
            sfc_g_h * (qs_sfc - qv_new[:, -1])
            * LATENT_HEAT_VAPORIZATION
        )
        t = (s_new - GRAV * z_mid) / CP_AIR
        qv = qv_new
        du_d, dv_d = _tendency_to_dgrid(ua_new - ua, va_new - va)
        u_d = u_d + du_d
        v_d = v_d + dv_d

    precip_conv = jnp.zeros(shape2d, t.dtype)
    if cfg.do_convection:
        if cfg.convection_scheme == "mass_flux":
            from .convection import sas_mass_flux

            t, qv, precip_conv = sas_mass_flux(
                t, qv, p, pe, delp, dt
            )
        else:
            t, qv, precip_conv = betts_miller(t, qv, p, delp, dt, cfg)

    if cfg.do_shallow_convection:
        from .gwd import shallow_convection

        t, qv, sc_diags = shallow_convection(t, qv, p, delp, dt)
        diags.update(sc_diags)

    if cfg.do_gwd and h_std is not None:
        from .gwd import gravity_wave_drag

        ua2, va2 = _to_agrid(u_d, v_d)
        du_a, dv_a, gwd_diags = gravity_wave_drag(
            ua2, va2, t, p, delp, h_std, dt
        )
        du_d, dv_d = _tendency_to_dgrid(du_a, dv_a)
        u_d = u_d + du_d
        v_d = v_d + dv_d
        diags.update(gwd_diags)

    precip_ls = jnp.zeros(shape2d, t.dtype)
    mp_out = None
    if cfg.do_microphysics:
        if cfg.microphysics_scheme == "gfdl":
            from .gfdl_mp import (
                gfdl_cloud_microphysics,
                liquid_fraction,
            )

            if mp_tracers is not None:
                # prognostic 6-species state: qc is cloud liquid, the
                # hydrometeors persist (and advect) between steps
                qi0, qr0, qs0, qg0 = mp_tracers
                ql0 = qc
            else:
                # reduced 2-tracer fallback: partition the combined
                # condensate diagnostically each step
                fl = liquid_fraction(t)
                ql0 = fl * qc
                qi0 = (1.0 - fl) * qc
                qr0 = qs0 = qg0 = jnp.zeros_like(qc)
            mp_state, mp_diags = gfdl_cloud_microphysics(
                t, qv, ql0, qi0, qr0, qs0, qg0, p, delp, dz, dt,
            )
            t = mp_state["air_temperature"]
            qv = mp_state["specific_humidity"]
            if mp_tracers is not None:
                qc = mp_state["cloud_water_mixing_ratio"]
                mp_out = (
                    mp_state["cloud_ice_mixing_ratio"],
                    mp_state["rain_mixing_ratio"],
                    mp_state["snow_mixing_ratio"],
                    mp_state["graupel_mixing_ratio"],
                )
            else:
                # fold all suspended condensate back into qc
                # (water-conserving)
                qc = (
                    mp_state["cloud_water_mixing_ratio"]
                    + mp_state["cloud_ice_mixing_ratio"]
                    + mp_state["rain_mixing_ratio"]
                    + mp_state["snow_mixing_ratio"]
                    + mp_state["graupel_mixing_ratio"]
                )
            diags.update(
                {
                    k: mp_diags[k]
                    for k in (
                        "rain_precipitation",
                        "snow_precipitation",
                        "graupel_precipitation",
                    )
                }
            )
            precip_ls = mp_diags["total_precipitation_mp"]
        else:
            t, qv, qc = gscond(t, qv, qc, p, dt)
            t, qv, qc, precip_ls = precpd(
                t, qv, qc, p, delp, dt, cfg
            )

    state = {
        "air_temperature": t,
        "specific_humidity": qv,
        "cloud_water_mixing_ratio": qc,
        "u_dgrid": u_d,
        "v_dgrid": v_d,
    }
    if mp_out is not None:
        state.update(
            cloud_ice_mixing_ratio=mp_out[0],
            rain_mixing_ratio=mp_out[1],
            snow_mixing_ratio=mp_out[2],
            graupel_mixing_ratio=mp_out[3],
        )
    diags.update(
        sensible_heat_flux=shf,
        latent_heat_flux=lhf,
        planetary_boundary_layer_height=h_pbl,
        convective_precipitation=precip_conv,
        large_scale_precipitation=precip_ls,
        total_precipitation=precip_conv + precip_ls,
    )
    return state, diags
