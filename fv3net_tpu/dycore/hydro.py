"""Hydrostatic FV3-style dynamical core: Lagrangian layers + remap.

The 3D core (``fv_dynamics`` equivalent, hydrostatic branch): the
shallow-water machinery of sw.py applied per Lagrangian layer with a
theta-pi pressure-gradient force, n_split acoustic-style substepping,
accumulated mass fluxes for tracer transport, and a conservative PPM
vertical remap (ops.remap, the mappm algorithm with exact boundaries)
back to the hybrid ak/bk reference coordinate every k_split step --
mirroring the reference configuration's vertical structure
(k_split/n_split/hord_*/kord_* of
workflows/prognostic_c48_run/tests/test_regression.py:133-200).

Prognostic state (all [6, nz, ...] with D-grid staggering):
    delp  [6, nz, n, n]     layer pressure thickness (Pa)
    pt    [6, nz, n, n]     virtual potential temperature (K)
    u     [6, nz, n+1, n]   covariant x-wind on x-edges
    v     [6, nz, n, n+1]
    q     [ntracer, 6, nz, n, n]  tracer mixing ratios (optional)

The PGF uses the exact identity -grad(p)/rho = -grad_s(Phi)
- cp*theta_v*grad_s(pi) on a layer surface s (pi the Exner function),
which is free of the two-term hydrostatic cancellation.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CP_AIR, KAPPA, REFERENCE_SURFACE_PRESSURE
from ..grid.geometry import CubedSphereGrid
from ..grid.halo import (
    canonicalize_cgrid_boundary,
    halo_exchange,
    halo_exchange_cgrid,
    halo_exchange_dgrid,
)
from ..constants import GRAV
from ..ops.advection import fv_tp_2d, ppm_flux
from ..ops.remap import ppm_remap
from .riemann import layer_mean_pressure, sim1_solve
from ..grid.halo import average_dgrid_boundary
from .sw import (
    CORNER_DAMP_COEF,
    combined_wind_damping,
    _c_half_winds_common,
    _finish_c_half,
    _masked_vertex_set,
    padded_cgrid_winds,
    vertex_masks,
    FILTER_COEF,
    VORT_DAMP_COEF,
    SWMetrics,
    _shx,
    _shy,
    c_grid_winds,
    corner_div_damp,
    div_damp,
    scalar_filter,
    vort_damp,
)


class DycoreState(NamedTuple):
    delp: jax.Array
    pt: jax.Array
    u: jax.Array
    v: jax.Array
    q: Optional[jax.Array] = None  # [ntracer, 6, nz, n, n]
    # nonhydrostatic prognostics (reference namelist `hydrostatic: false`,
    # test_regression.py:133-200); delz < 0 by the FV3 restart convention
    w: Optional[jax.Array] = None  # [6, nz, n, n] vertical wind (m/s)
    delz: Optional[jax.Array] = None  # [6, nz, n, n] layer thickness (m)


def hybrid_coefficients(
    nz: int,
    ptop: float = 300.0,
    transition_eta: float = 0.2,
    exponent: float = 1.0,
    stretch: float = 1.4,
    table=None,
):
    """Hybrid sigma-p coefficients: pe = ak + bk * ps.

    Default: the published Jablonowski & Williamson (2006) / DCMIP
    hybrid definition (the standard coordinate for baroclinic-wave
    dycore validation): eta levels from eta_top = ptop/p0 to 1 with a
    power-law stretch clustering resolution near the surface,
    bk = ((eta - eta_t)/(1 - eta_t))^c above the transition (pure
    pressure for eta < eta_t, i.e. FV3's `ks` pure-pressure top
    layers), ak = p0*(eta - bk).  This replaces the round-1 sin^2
    stand-in; npz=63 with ptop=64.247 Pa matches the GFS envelope of
    the reference C12 config (fv_core_nml npz: 63,
    test_regression.py:133-200).  FV3's bit-exact tabulated ak/bk are
    not in the reference tree (fv_eta.F90 lives in the empty
    fortran submodule); pass ``table=(ak, bk)`` — e.g. read from a
    Fortran ``fv_core.res.nc`` restart via io.netcdf3 — to use exact
    values.
    """
    if table is not None:
        ak, bk = table
        ak = np.asarray(ak, np.float64)
        bk = np.asarray(bk, np.float64)
        if ak.shape != (nz + 1,) or bk.shape != (nz + 1,):
            raise ValueError(
                f"ak/bk table must have {nz + 1} interfaces, got "
                f"{ak.shape}/{bk.shape}"
            )
        return jnp.asarray(ak), jnp.asarray(bk)
    p0 = REFERENCE_SURFACE_PRESSURE
    eta_top = ptop / p0
    s = np.linspace(0.0, 1.0, nz + 1)
    eta = eta_top + (1.0 - eta_top) * s ** stretch
    bk = np.where(
        eta > transition_eta,
        ((eta - transition_eta) / (1.0 - transition_eta)) ** exponent,
        0.0,
    )
    bk[-1] = 1.0
    ak = p0 * (eta - bk)
    ak[-1] = 0.0
    # interfaces must stay monotone down to mountain-top surface
    # pressures (exponent > 1 transitions lose this below ~p0(1-1/c'))
    for ps in (45000.0, 101300.0):
        if not (np.diff(ak + bk * ps) > 0).all():
            raise ValueError(
                "non-monotone hybrid coordinate for ps="
                f"{ps}; lower `exponent` or `transition_eta`"
            )
    return jnp.asarray(ak), jnp.asarray(bk)


def add_nonhydrostatic_fields(state: DycoreState, ptop: float):
    """Attach w=0 and hydrostatically balanced delz to a state."""
    from .riemann import hydrostatic_dz

    pe = ptop + jnp.concatenate(
        [jnp.zeros_like(state.delp[:, :1]),
         jnp.cumsum(state.delp, axis=1)], axis=1
    )
    delz = hydrostatic_dz(state.delp, state.pt, pe)
    return state._replace(w=jnp.zeros_like(state.delp), delz=delz)


def _corner_avg(phi):
    """Cell-centered [.., N, N] -> corner lattice [.., N+1, N+1]."""
    pe = jnp.pad(
        phi,
        [(0, 0)] * (phi.ndim - 2) + [(1, 1), (1, 1)],
        mode="edge",
    )
    return 0.25 * (
        pe[..., :-1, :-1] + pe[..., :-1, 1:] + pe[..., 1:, :-1]
        + pe[..., 1:, 1:]
    )


def _vertex_fix_scalar_corner(arr_c, vals3, h, n, masks=(None,) * 4):
    """Replace cube-corner vertex entries of a corner-lattice array.

    masks: per-vertex applicability (sw.vertex_masks) -- under
    within-face tiling only tiles touching the cube vertex apply the
    fix; None means always (face level)."""
    hn = h + n
    for (cj, ci), v3, vm in zip(
        ((h, h), (h, hn), (hn, h), (hn, hn)), vals3, masks
    ):
        arr_c = _masked_vertex_set(arr_c, (cj, ci), v3, vm)
    return arr_c


def _vertex_cells(phi, h, n):
    """3-real-cell means at the 4 cube-corner vertices of a padded
    cell-centered field (same convention as sw.py)."""
    hn = h + n
    spec = (
        ((h - 1, h), (h, h - 1), (h, h)),
        ((h - 1, hn - 1), (h, hn), (h, hn - 1)),
        ((hn, h), (hn - 1, h), (hn - 1, h - 1)),
        ((hn, hn - 1), (hn - 1, hn), (hn - 1, hn - 1)),
    )
    return [
        sum(phi[..., j, i] for j, i in cells) / 3.0 for cells in spec
    ]


def column_pressures(dp, ptop):
    """Interface pressures, interface Exner and layer-mean Exner of
    (padded) columns with the level axis at position 1.

    pe = ptop + prefix sum of dp; pik = (pe/p00)**kappa with pe floored
    at 1e-30 so unused halo-corner columns stay finite; the layer mean
    is the hydrostatically consistent
    (pik+ * pe+ - pik- * pe-) / ((1+kappa) * dp).
    """
    pe = ptop + jnp.concatenate(
        [jnp.zeros_like(dp[:, :1]), jnp.cumsum(dp, axis=1)], axis=1
    )
    pik = (jnp.maximum(pe, 1e-30) / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    pi_lay = (
        pik[:, 1:] * pe[:, 1:] - pik[:, :-1] * pe[:, :-1]
    ) / ((1.0 + KAPPA) * dp)
    return pe, pik, pi_lay


def _c_sw_half_3d(state: DycoreState, m: SWMetrics, dt2: float,
                  ptop: float, phis, up, vp, dpx, dpy, ptx, pty):
    """FV3 ``c_sw`` role, 3D form: a cheap C-grid half step.

    Advances delp/pt by dt2 with 1st-order upwind fluxes and the C
    winds by dt2 with a forward-backward momentum update (absolute
    vorticity x tangential wind + cell-KE, Exner-form PGF and
    hydrostatic geopotential gradients from the half-updated mass
    field), producing time-centered ADVECTIVE winds for the full D
    stage.  Only the advecting C winds are time-centered -- the D-grid
    prognostics update once from time-n fields, exactly FV3's c_sw/d_sw
    split -- replacing the full-cost provisional D half-step the legacy
    midpoint scheme paid (measured 303 ms of the 1046 ms C192 step,
    tools/PROFILE_C192_r5.md).  The half-stage PGF is hydrostatic even
    in nonhydrostatic runs (Riem_Solver_C's role is folded into the
    full stage's semi-implicit solve on the transported state).
    """
    uc, vc, vc_on_x, uc_on_y = padded_cgrid_winds(
        state.u, state.v, m, up, vp
    )
    bc, ke, rarea_p, zf_u, zf_v, vbar_u, ubar_v = _c_half_winds_common(
        uc, vc, vc_on_x, uc_on_y, up, vp, m
    )
    # upwind half-step mass/heat transport on the padded lattice
    # (interior + edge bands valid; corner blocks never consumed)
    fx = ppm_flux(dpx, uc, -1, 1) * (uc * dt2 * bc(m.dy_fs))
    fy = ppm_flux(dpy, vc, -2, 1) * (vc * dt2 * bc(m.dx_fs))
    div = (fx - _shx(fx, 1)) + (fy - _shy(fy, 1))
    delpc = dpx + div * rarea_p
    fxt = ppm_flux(ptx, uc, -1, 1) * fx
    fyt = ppm_flux(pty, vc, -2, 1) * fy
    divt = (fxt - _shx(fxt, 1)) + (fyt - _shy(fyt, 1))
    ptc = (ptx * dpx + divt * rarea_p) / delpc

    # Exner + hydrostatic geopotential of the half-updated columns
    _, pik, pi_lay = column_pressures(delpc, ptop)
    dphi = CP_AIR * ptc * (pik[:, 1:] - pik[:, :-1])
    phi_if_rev = jnp.concatenate(
        [jnp.zeros_like(delpc[:, :1]),
         jnp.cumsum(dphi[:, ::-1], axis=1)], axis=1
    )
    phi_if = phi_if_rev[:, ::-1]
    if phis is not None:
        phi_if = phi_if + halo_exchange(phis, m.halo, fill="x")[:, None]
    phi_lay = 0.5 * (phi_if[:, 1:] + phi_if[:, :-1])
    kphi = ke + phi_lay

    ptf_u = 0.5 * (ptc + _shx(ptc, -1))
    ptf_v = 0.5 * (ptc + _shy(ptc, -1))
    duc = dt2 * (
        zf_u * vbar_u
        - (
            (kphi - _shx(kphi, -1))
            + CP_AIR * ptf_u * (pi_lay - _shx(pi_lay, -1))
        ) / bc(m.dxc_f)
    )
    dvc = dt2 * (
        -zf_v * ubar_v
        - (
            (kphi - _shy(kphi, -1))
            + CP_AIR * ptf_v * (pi_lay - _shy(pi_lay, -1))
        ) / bc(m.dyc_f)
    )
    return _finish_c_half(uc, vc, duc, dvc, m)


def dyn_substep(state: DycoreState, m: SWMetrics, dt: float, ptop: float,
                hord: int, d2_damp: float, phis,
                mfx_acc, mfy_acc, cx_acc, cy_acc,
                midpoint: bool = True, c_half: bool = True):
    """One acoustic-style substep on the Lagrangian layers.

    midpoint=True: time-centered advective winds.  c_half=True (the
    default) uses the cheap C-grid half-stage (``_c_sw_half_3d``,
    FV3's c_sw role): only the advecting C winds are half-stepped and
    the D stage runs once from the time-n state.  c_half=False keeps
    the legacy two-stage midpoint scheme (a full provisional D-grid
    half step with 1st-order reconstruction); midpoint=False is plain
    forward-backward (weakly unstable for rotational modes, see
    sw.shallow_water_step).

    Returns (new_state_without_tracers, accumulated fluxes).
    """
    if midpoint and c_half:
        h = m.halo
        up, vp = halo_exchange_dgrid(state.u, state.v, h)
        dpx = halo_exchange(state.delp, h, fill="x")
        dpy = halo_exchange(state.delp, h, fill="y")
        ptx = halo_exchange(state.pt, h, fill="x")
        pty = halo_exchange(state.pt, h, fill="y")
        adv = _c_sw_half_3d(
            state, m, 0.5 * dt, ptop, phis, up, vp, dpx, dpy, ptx, pty
        )
        new, (fx, fy, crx, cry) = _substep_core(
            state, state, m, dt, ptop, hord, d2_damp, phis,
            exch=(up, vp, dpx, dpy, ptx, pty), adv=adv,
        )
    elif midpoint:
        # nondimensional damping applied once per substep (stage 2)
        half, _ = _substep_core(state, state, m, 0.5 * dt, ptop, 1,
                                0.0, phis)
        new, (fx, fy, crx, cry) = _substep_core(
            half, state, m, dt, ptop, hord, d2_damp, phis
        )
    else:
        new, (fx, fy, crx, cry) = _substep_core(
            state, state, m, dt, ptop, hord, d2_damp, phis
        )
    if mfx_acc is None:  # tracer-free run: no accumulation carried
        return new, (None, None, None, None)
    return new, (mfx_acc + fx, mfy_acc + fy, cx_acc + crx, cy_acc + cry)


def _substep_core(ev: DycoreState, base: DycoreState, m: SWMetrics,
                  dt: float, ptop: float, hord: int, d2_damp: float,
                  phis, exch=None, adv=None):
    """Flux-form update of `base` with fluxes/gradients evaluated on
    `ev` (midpoint stage form; ev is base for forward-backward; under
    the c_sw scheme ev IS base and `adv` carries the time-centered
    advective C winds from the half-stage).

    exch: optional precomputed (up, vp, dpx, dpy, ptx, pty) halo
    exchanges of ev's fields (shared with the C half-stage).  adv:
    optional (uc, vc) padded advective winds; when given the internal
    C-wind derivation from ev's D winds is skipped.

    Hydrostatic when w is None; otherwise nonhydrostatic: w is
    transported mass-weighted and delz volume-weighted alongside the
    other prognostics, the semi-implicit Riemann solver (riemann.py)
    advances the vertical acoustics, the geopotential in the wind
    update comes from the TRUE layer heights (delz), and the winds get
    the perturbation-pressure gradient -(1/rho) grad_s(p') on top of
    the hydrostatic cp*theta*grad(pi) term (pointwise-exact split of
    the full PGF, no hydrostatic assumption).
    """
    h, n = m.halo, m.n
    N = n + 2 * h
    delp, pt, u, v = ev.delp, ev.pt, ev.u, ev.v
    nonhydro = ev.w is not None

    if exch is not None:
        up, vp, dpx, dpy, ptx, pty = exch
    else:
        up, vp = halo_exchange_dgrid(u, v, h)
        dpx = halo_exchange(delp, h, fill="x")
        dpy = halo_exchange(delp, h, fill="y")
        ptx = halo_exchange(pt, h, fill="x")
        pty = halo_exchange(pt, h, fill="y")

    if adv is not None:
        uc, vc = adv
    else:
        # C-face contravariant winds, canonical (see sw.c_grid_winds)
        uc_A, vc_A = c_grid_winds(up, vp, m)
        uc_int = uc_A[:, :, h : h + n, h : h + n + 1]
        vc_int = vc_A[:, :, h : h + n + 1, h : h + n]
        uc_int, vc_int = canonicalize_cgrid_boundary(uc_int, vc_int)
        ucx_p, _ = halo_exchange_cgrid(uc_int, vc_int, h, fill="x")
        _, vcy_p = halo_exchange_cgrid(uc_int, vc_int, h, fill="y")
        uc = ucx_p[:, :, :, :N]
        vc = vcy_p[:, :, :N, :]

    crx = uc * dt / m.dxc_f[:, None]
    cry = vc * dt / m.dyc_f[:, None]
    xfx = uc * dt * m.dy_fs[:, None]
    yfx = vc * dt * m.dx_fs[:, None]

    # absolute vorticity (transported with the mass fluxes below)
    udx = u * m.dx_u[:, None, h : h + n + 1, h : h + n]
    vdy = v * m.dy_v[:, None, h : h + n, h : h + n + 1]
    vort = (
        udx[:, :, :-1, :] - udx[:, :, 1:, :]
        + vdy[:, :, :, 1:] - vdy[:, :, :, :-1]
    )
    zeta_int = vort * m.rarea[:, None]
    omega_x = halo_exchange(zeta_int, h, fill="x") + m.f_px[:, None]
    omega_y = halo_exchange(zeta_int, h, fill="y") + m.f_py[:, None]
    sfx = uc * dt * m.sina_u[:, None]
    sfy = vc * dt * m.sina_v[:, None]

    fx, fy = fv_tp_2d(
        dpx, dpy, crx, cry, xfx, yfx, m.area_px[:, None],
        m.area_py[:, None], hord,
    )
    # potential temperature: mass-weighted transport with the delp
    # fluxes; the Lin-Rood inner update divides by the transversely
    # updated AIR MASS (area * delp), which must be dimensionally
    # consistent with the fluxes
    fxt, fyt = fv_tp_2d(
        ptx, pty, crx, cry, fx, fy,
        m.area_px[:, None] * dpx, m.area_py[:, None] * dpy, hord,
    )
    fxo, fyo = fv_tp_2d(
        omega_x, omega_y, crx, cry, sfx, sfy,
        m.area_px[:, None], m.area_py[:, None], hord,
    )
    if nonhydro:
        wx = halo_exchange(ev.w, h, fill="x")
        wy = halo_exchange(ev.w, h, fill="y")
        fxw, fyw = fv_tp_2d(
            wx, wy, crx, cry, fx, fy,
            m.area_px[:, None] * dpx, m.area_py[:, None] * dpy,
            hord,
        )
        dzx = halo_exchange(ev.delz, h, fill="x")
        dzy = halo_exchange(ev.delz, h, fill="y")
        fxz, fyz = fv_tp_2d(
            dzx, dzy, crx, cry, xfx, yfx,
            m.area_px[:, None], m.area_py[:, None], hord,
        )

    div = (fx - _shx(fx, 1)) + (fy - _shy(fy, 1))
    delp_new = base.delp + div[
        :, :, h : h + n, h : h + n
    ] * m.rarea[:, None]
    divt = (fxt - _shx(fxt, 1)) + (fyt - _shy(fyt, 1))
    ptdp = (
        base.pt * base.delp
        + divt[:, :, h : h + n, h : h + n] * m.rarea[:, None]
    )
    # NOTE: batching the four scalar_filter calls into one stacked
    # call (tried here in r5, like the stacked transports in r3) is
    # bit-equivalent but SLOWER: C192 820 -> 943 ms/step.  XLA's 2D
    # stencil fusions break across the stacked axis.  Keep per-field
    # calls.
    fc = FILTER_COEF if d2_damp != 0.0 else 0.0
    delp_new = scalar_filter(delp_new, m, fc)
    pt_new = scalar_filter(ptdp, m, fc) / delp_new

    if nonhydro:
        # w: mass-weighted (like pt); delz: volume-form with the area
        # fluxes (conserves total volume) -- fluxes computed above
        divw = (fxw - _shx(fxw, 1)) + (fyw - _shy(fyw, 1))
        w_adv = scalar_filter(
            base.w * base.delp
            + divw[:, :, h : h + n, h : h + n] * m.rarea[:, None],
            m, fc,
        ) / delp_new
        divz = (fxz - _shx(fxz, 1)) + (fyz - _shy(fyz, 1))
        dz_adv = scalar_filter(
            base.delz + divz[
                :, :, h : h + n, h : h + n
            ] * m.rarea[:, None],
            m, fc,
        )

    # --- kinetic energy + PGF at corners ---------------------------------
    ub = 0.5 * (_shx(up, -1) + up)
    vb = 0.5 * (_shy(vp, -1) + vp)
    ubp = jnp.pad(ub, ((0, 0), (0, 0), (0, 0), (0, 1)))
    vbp = jnp.pad(vb, ((0, 0), (0, 0), (0, 1), (0, 0)))
    # |V|^2 = (u1^2 + u2^2 - 2 cosa u1 u2) / sin^2 (covariant metric)
    ke_c = 0.5 * (
        ubp ** 2 + vbp ** 2
        - 2.0 * m.cosa_b[:, None] * ubp * vbp
    ) * m.rsin2_b[:, None]
    hn = h + n
    vmasks = vertex_masks(m)
    vert_edges = (
        ((h, h), ((up, h, h), (vp, h, h), (vp, h - 1, h))),
        ((h, hn), ((up, h, hn - 1), (vp, h, hn), (vp, h - 1, hn))),
        ((hn, h), ((up, hn, h), (vp, hn - 1, h), (vp, hn, h))),
        ((hn, hn), ((up, hn, hn - 1), (vp, hn - 1, hn), (vp, hn, hn))),
    )
    for ((cj, ci), es), vm in zip(vert_edges, vmasks):
        a, b, c = (arr[:, :, j, i] for arr, j, i in es)
        ke_c = _masked_vertex_set(
            ke_c, (cj, ci), (a * a + b * b + c * c) / 3.0, vm
        )

    # hydrostatic geopotential and Exner function on the NEW mass field
    # (forward-backward coupling), all on fill='y' padded fields
    dp_p = halo_exchange(delp_new, h, fill="y")
    pt_p = halo_exchange(pt_new, h, fill="y")
    pe_p, pik, pi_lay = column_pressures(dp_p, ptop)
    # geopotential: integrate cp*theta*d(pi) upward from the surface
    phis_p = (
        halo_exchange(phis, h, fill="y")[:, None]
        if phis is not None
        else 0.0
    )
    if nonhydro:
        # vertical acoustics: semi-implicit solve on the transported
        # state (Riem_Solver3 position in fv_dynamics), then the TRUE
        # geopotential from the solved layer heights
        pe_int = pe_p[:, :, h : h + n, h : h + n]
        pm_int = layer_mean_pressure(delp_new, pe_int)
        dm_int = delp_new / GRAV
        if phis is not None:
            # terrain BC: ws = V . grad(z_s) from bottom-level C-winds
            zs = phis / GRAV
            zsx = halo_exchange(zs, h, fill="x")
            zsy = halo_exchange(zs, h, fill="y")
            dzdx_f = (zsx - _shx(zsx, -1)) / m.dxc_f
            dzdy_f = (zsy - _shy(zsy, -1)) / m.dyc_f
            ucb, vcb = uc[:, -1], vc[:, -1]
            ws_full = 0.5 * (
                ucb * dzdx_f + _shx(ucb * dzdx_f, 1)
                + vcb * dzdy_f + _shy(vcb * dzdy_f, 1)
            )
            ws = ws_full[:, h : h + n, h : h + n]
        else:
            ws = jnp.zeros_like(delp_new[:, 0])
        w2, dz2, ppe = sim1_solve(
            dt, dm_int, pt_new, dz_adv, w_adv, pe_int, pm_int, ws
        )
        dz_p = halo_exchange(dz2, h, fill="y")
        dphi = -GRAV * dz_p  # positive downward
    else:
        # hydrostatic: integrate cp*theta*d(pi)
        dphi = CP_AIR * pt_p * (pik[:, 1:] - pik[:, :-1])
    # interface geopotential from bottom: Phi_if[nz] = phis
    phi_if_rev = jnp.concatenate(
        [jnp.zeros_like(dp_p[:, :1]),
         jnp.cumsum(dphi[:, ::-1], axis=1)], axis=1
    )
    phi_if = phi_if_rev[:, ::-1] + phis_p  # [6, nz+1, N, N]
    phi_lay = 0.5 * (phi_if[:, 1:] + phi_if[:, :-1])

    phi_c = _corner_avg(phi_lay)
    pi_c = _corner_avg(pi_lay)
    phi_c = _vertex_fix_scalar_corner(
        phi_c, _vertex_cells(phi_lay, h, n), h, n, vmasks
    )
    pi_c = _vertex_fix_scalar_corner(
        pi_c, _vertex_cells(pi_lay, h, n), h, n, vmasks
    )
    ke_phi = ke_c + phi_c

    # center -> wind-point averaging for PGF coefficient fields
    def to_u(f):  # [6, nz, N, N] -> [6, nz, N+1, N]
        return jnp.concatenate(
            [f[:, :, :1], 0.5 * (f[:, :, 1:] + f[:, :, :-1]),
             f[:, :, -1:]], axis=2
        )

    def to_v(f):  # [6, nz, N, N] -> [6, nz, N, N+1]
        return jnp.concatenate(
            [f[:, :, :, :1], 0.5 * (f[:, :, :, 1:] + f[:, :, :, :-1]),
             f[:, :, :, -1:]], axis=3
        )

    # theta at wind points for the cp*theta*grad(pi) term
    pt_at_u = to_u(pt_p)  # [6, nz, N+1, N]
    pt_at_v = to_v(pt_p)  # [6, nz, N, N+1]

    # --- dissipation on the BASE winds (once per substep: the midpoint
    # half-stage passes d2_damp=0, which disables ALL dissipation --
    # applying the non-dt-scaled dampers per stage would both double
    # their strength and double the compile graph) -------------------------
    if d2_damp != 0.0:
        # NOTE: a combined single-vjp form of the three dampers
        # (sw.combined_wind_damping) halves the exchange chains but
        # compiles far slower than the three separate vjps; keep them.
        du_damp, dv_damp = div_damp(base.u, base.v, m, d2_damp)
        du_vd, dv_vd = vort_damp(base.u, base.v, m, VORT_DAMP_COEF)
        du_cd, dv_cd = corner_div_damp(
            base.u, base.v, m, CORNER_DAMP_COEF
        )
        du_damp = du_damp + du_vd + du_cd
        dv_damp = dv_damp + dv_vd + dv_cd
    else:
        du_damp = jnp.zeros_like(base.u)
        dv_damp = jnp.zeros_like(base.v)

    # --- wind updates -----------------------------------------------------
    dku = ke_phi[:, :, :, 1:] - ke_phi[:, :, :, :-1]
    dkv = ke_phi[:, :, 1:, :] - ke_phi[:, :, :-1, :]
    dpiu = pi_c[:, :, :, 1:] - pi_c[:, :, :, :-1]
    dpiv = pi_c[:, :, 1:, :] - pi_c[:, :, :-1, :]
    fyo_u = jnp.pad(fyo, ((0, 0), (0, 0), (0, 1), (0, 0)))
    fxo_v = jnp.pad(fxo, ((0, 0), (0, 0), (0, 0), (0, 1)))
    u_new_p = (
        fyo_u
        - (dt / m.dx_u[:, None]) * (dku + CP_AIR * pt_at_u * dpiu)
    )
    v_new_p = (
        -fxo_v
        - (dt / m.dy_v[:, None]) * (dkv + CP_AIR * pt_at_v * dpiv)
    )

    if nonhydro:
        # perturbation-pressure gradient -(1/rho) grad_s(p') (the
        # nonhydrostatic part of the split PGF; nh_p_grad equivalent)
        pp_lay = 0.5 * (ppe[:, :-1] + ppe[:, 1:])
        alpha = -dz2 * GRAV / delp_new  # specific volume 1/rho
        pp_y = halo_exchange(pp_lay, h, fill="y")
        al_y = halo_exchange(alpha, h, fill="y")
        pp_c = _corner_avg(pp_y)
        pp_c = _vertex_fix_scalar_corner(
            pp_c, _vertex_cells(pp_y, h, n), h, n, vmasks
        )
        u_new_p = u_new_p - (dt / m.dx_u[:, None]) * to_u(al_y) * (
            pp_c[:, :, :, 1:] - pp_c[:, :, :, :-1]
        )
        v_new_p = v_new_p - (dt / m.dy_v[:, None]) * to_v(al_y) * (
            pp_c[:, :, 1:, :] - pp_c[:, :, :-1, :]
        )

    u_new = (
        base.u + u_new_p[:, :, h : h + n + 1, h : h + n] + du_damp
    )
    v_new = (
        base.v + v_new_p[:, :, h : h + n, h : h + n + 1] + dv_damp
    )
    # re-impose single-valuedness of shared boundary D-edges
    u_new, v_new = average_dgrid_boundary(u_new, v_new)

    new = DycoreState(
        delp_new, pt_new, u_new, v_new, base.q,
        w2 if nonhydro else None, dz2 if nonhydro else None,
    )
    return new, (fx, fy, crx, cry)


@jax.named_scope("remap")
def remap_step(state: DycoreState, ak, bk, ptop, kord_tm=9, kord_mt=9,
               kord_tr=9, kord_wz=9):
    """Lagrangian -> Eulerian vertical remap to the ak/bk coordinate."""
    delp, pt, u, v, q, w, delz = state
    # source interface pressures
    pe1 = ptop + jnp.concatenate(
        [jnp.zeros_like(delp[:, :1]), jnp.cumsum(delp, axis=1)], axis=1
    )
    ps = pe1[:, -1:]
    shape_tail = (1,) * (delp.ndim - 2)
    pe2 = ak.reshape((1, -1) + shape_tail) + bk.reshape(
        (1, -1) + shape_tail
    ) * ps

    def rmp(qq, p1, p2, iv, kord):
        return jnp.moveaxis(
            ppm_remap(
                jnp.moveaxis(qq, 1, 0),
                jnp.moveaxis(p1, 1, 0),
                jnp.moveaxis(p2, 1, 0),
                iv=iv, kord=kord, exact_boundaries=True,
            ),
            0, 1,
        )

    pt_new = rmp(pt, pe1, pe2, 1, kord_tm)
    delp_new = pe2[:, 1:] - pe2[:, :-1]

    # winds: average interface pressures to the staggered positions.
    # The neighbor cell across a within-face TILE boundary must come
    # from the owning tile (extend_cells_one); at face edges the
    # extension is edge-replicated so 0.5*(p+p) reproduces the
    # one-sided form bit-for-bit.
    from ..grid.halo import extend_cells_one

    def stag_u(p):  # [6, nz+1, n, n] -> [6, nz+1, n+1, n]
        ext = extend_cells_one(p)
        return 0.5 * (ext[:, :, :-1, 1:-1] + ext[:, :, 1:, 1:-1])

    def stag_v(p):
        ext = extend_cells_one(p)
        return 0.5 * (ext[:, :, 1:-1, :-1] + ext[:, :, 1:-1, 1:])

    u_new = rmp(u, stag_u(pe1), stag_u(pe2), -1, kord_mt)
    v_new = rmp(v, stag_v(pe1), stag_v(pe2), -1, kord_mt)
    if q is not None:
        # one vmapped remap instance serves every tracer
        q_new = jax.vmap(lambda qq: rmp(qq, pe1, pe2, 0, kord_tr))(q)
    else:
        q_new = None
    if w is not None:
        # w like a wind (kord_wz), delz via the specific volume -dz/dp
        # (mass-weighted, so total column height is conserved)
        w_new = rmp(w, pe1, pe2, -1, kord_wz)
        sv = -delz / delp
        sv_new = rmp(sv, pe1, pe2, 1, kord_wz)
        delz_new = -sv_new * delp_new
    else:
        w_new, delz_new = None, None
    return DycoreState(
        delp_new, pt_new, u_new, v_new, q_new, w_new, delz_new
    )


def make_dycore_stepper(
    g: CubedSphereGrid,
    nz: int,
    dt_atmos: float,
    k_split: int = 1,
    n_split: int = 6,
    hord: int = 5,
    kord: int = 9,
    d2_damp: float = 0.12,
    ptop: float = 300.0,
    dtype=jnp.float32,
    remat: bool = False,
    metric_cwinds: bool = True,
    metric_ke: bool = True,
    corner_damp: bool = True,
    donate: bool = False,
    c_half: bool = True,
):
    """Build a jitted full dycore step (dynamics + vertical remap).

    Mirrors the reference namelist structure (k_split outer loops each
    ending in a remap, n_split substeps inside).

    remat: checkpoint each acoustic substep (jax.checkpoint), trading
    recompute for peak HBM — required to fit C384 x 63 on one chip.
    """
    # Metrics are built on the host CPU backend and placed on the
    # default device in one transfer.  They enter every compiled step
    # as constants, so the backend that computes them is part of each
    # program's compile-cache key.  (Building them on the device was
    # the faster set-up at C192 on an H100 80GB HBM3, 700 W: 6.5 s
    # against 10.9 s, tools/profile_step.py setup; ROADMAP 1.7.)
    try:
        cpu = jax.local_devices(backend="cpu")[0]  # NOT jax.devices:
        # that list is global in multi-process mode
    except RuntimeError:
        cpu = None
    with jax.default_device(cpu):
        m = SWMetrics.make(
            g, dtype, metric_cwinds=metric_cwinds, metric_ke=metric_ke,
            corner_damp=corner_damp,
        )
    dev = jax.config.jax_default_device or jax.local_devices()[0]
    if dev != cpu:
        import dataclasses as _dc

        m = _dc.replace(
            m,
            **{
                f.name: jax.device_put(getattr(m, f.name), dev)
                for f in _dc.fields(m)
                if isinstance(getattr(m, f.name), jax.Array)
            },
        )
    ak, bk = hybrid_coefficients(nz, ptop)
    one_dt = build_one_dt(
        m, ak.astype(dtype), bk.astype(dtype), nz, dt_atmos, k_split,
        n_split, hord, kord, d2_damp, ptop, dtype, remat,
        c_half=c_half,
    )

    # donate=True aliases the input state buffers into the outputs
    # (saves one full state copy of HBM; at C384 x 63 that is ~1.3 GB).
    # Off by default: callers that reuse the input after stepping
    # (tests, conservation checks) must keep their buffers.
    @partial(
        jax.jit,
        static_argnames=("nsteps",),
        donate_argnums=(0,) if donate else (),
    )
    def run(state: DycoreState, phis, nsteps: int):
        def body(s, _):
            return one_dt(s, phis), None

        out, _ = jax.lax.scan(body, state, None, length=nsteps)
        return out

    # the un-jitted one-dt body: the compiled TimeLoop
    # (runtime/compiled_loop.py) traces it INSIDE its fused coupled
    # step instead of paying a separate dispatch per substep
    run.one_dt = one_dt
    return run, m, (ak, bk)


def build_one_dt(m, ak, bk, nz, dt_atmos, k_split, n_split, hord, kord,
                 d2_damp, ptop, dtype, remat=False, c_half=True):
    """The full-dt step (k_split x [n_split substeps + tracer transport
    + remap]) as a reusable pure function of (state, phis).

    Works for the full cube (metrics with face dim 6, state [6, ...])
    AND inside shard_map with per-face-sliced metrics (face dim 1) --
    the SPMD dycore (parallel/spmd_dycore.py) reuses it unchanged with
    the halo backend switched to ppermute exchanges.
    """
    dt_sub = dt_atmos / (k_split * n_split)
    h, n = m.halo, m.n
    N = n + 2 * h

    def one_dt(state: DycoreState, phis):
        nface = state.delp.shape[0]
        need_acc = state.q is not None

        def outer(st, _):
            # flux accumulators feed ONLY the tracer transport: carrying
            # them with no tracers wastes 4 padded-field scan slots
            # (3.7 GB at C384 x 63 — the difference between fitting in
            # one chip's HBM and not).  When present they are derived
            # from the state so that under shard_map they carry the
            # same varying-axis type as the scan outputs (a literal
            # jnp.zeros would be "replicated").
            if need_acc:
                zero_f = jnp.zeros((nface, nz, N, N), dtype) + (
                    0.0 * st.delp[:, :, :1, :1]
                ).astype(dtype)
                acc = (zero_f, zero_f, zero_f, zero_f)
            else:
                acc = None

            def inner(carry, __):
                s, a = carry
                s2, a2 = dyn_substep(
                    s, m, dt_sub, ptop, hord, d2_damp, phis,
                    *(a if a is not None else (None,) * 4),
                    c_half=c_half,
                )
                return (s2, a2 if a is not None else None), None

            if remat:
                inner = jax.checkpoint(inner)

            (st2, acc), _ = jax.lax.scan(
                inner, (st, acc), None, length=n_split
            )
            mfx, mfy, cxa, cya = acc if acc is not None else (None,) * 4
            # tracer transport with accumulated mass fluxes
            if st2.q is not None:
                dp0x = halo_exchange(st.delp, h, fill="x")
                dp0y = halo_exchange(st.delp, h, fill="y")

                def tr(qq):
                    qx = halo_exchange(qq, h, fill="x")
                    qy = halo_exchange(qq, h, fill="y")
                    fxq, fyq = fv_tp_2d(
                        qx, qy, cxa, cya, mfx, mfy,
                        m.area_px[:, None] * dp0x,
                        m.area_py[:, None] * dp0y, hord,
                    )
                    dv = (fxq - _shx(fxq, 1)) + (fyq - _shy(fyq, 1))
                    old_dp = st.delp
                    return (
                        qq * old_dp
                        + dv[:, :, h : h + n, h : h + n] * m.rarea[:, None]
                    ) / st2.delp

                st2 = st2._replace(q=jax.vmap(tr)(st2.q))
            st3 = remap_step(st2, ak, bk, ptop, kord, kord, kord, kord)
            return st3, None

        out, _ = jax.lax.scan(outer, state, None, length=k_split)
        return out

    return one_dt
