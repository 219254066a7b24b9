"""Semi-implicit nonhydrostatic vertical solver (Riemann solver).

The JAX equivalent of FV3's `Riem_Solver3`/`SIM1_solver`
(reference submodule `external/fv3gfs-fortran`, not in tree; configured
fully implicit by `a_imp: 1.0` in the reference C12 namelist,
workflows/prognostic_c48_run/tests/test_regression.py:133-200, which
also sets `hydrostatic: false` -- i.e. THIS solver is on the
reference's hot path).  It advances vertically propagating sound waves
implicitly so the acoustic substep dt is not limited by the vertical
CFL (dz ~ tens of meters near the surface vs c_s*dt ~ tens of km).

Column system (k index increasing downward, w positive up, delz < 0 by
the FV3 restart convention -- cf. vcm/cubedsphere/constants.py
RESTART_Z_CENTER dims):

    dm * dw/dt = p'(below) - p'(above)          (perturbation force)
    d(delz)/dt = w(top i/f) - w(bottom i/f)     (compression)
    p_full     = p0 * (-dm R theta_v / (delz p0))**gamma   (gas law)
    p'         = p_full - p_hydro

Backward-Euler linearization couples neighboring layers through the
interface stiffness aa_k = 2 gamma dt^2 (p_if)/ (dz_{k-1}+dz_k), giving
one bidiagonal solve for the provisional interface perturbation and one
tridiagonal (Thomas) solve for w.  The reference form below runs them as
`lax.scan` over the levels with all 6*n*n columns batched per step; on
the GPU a fused Triton kernel (ops/pallas_sim1.py) walks the levels of
each column block in one program.

Boundary conditions: p' = 0 at the model top (open); at the surface the
material boundary condition w = ws (terrain-following surface vertical
motion, ws = V . grad(z_s)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import (
    CP_AIR,
    CV_AIR,
    GRAV,
    KAPPA,
    RDGAS,
    REFERENCE_SURFACE_PRESSURE as P00,
)

GAMMA = CP_AIR / CV_AIR


def full_pressure(dm, pt, dz):
    """Ideal-gas full pressure from mass, theta_v, and (negative) dz."""
    rho_rtheta = -dm * RDGAS * pt / dz  # > 0 since dz < 0
    return P00 * (rho_rtheta / P00) ** GAMMA


def dz_from_pressure(dm, pt, p):
    """Invert the gas law: (negative) layer thickness at pressure p."""
    return -(dm * RDGAS * pt / P00) * (p / P00) ** (-CV_AIR / CP_AIR)


@jax.named_scope("vertical_solver")
def sim1_solve(dt, dm, pt, dz, w, pem, pm, ws, p_fac: float = 0.05):
    """Dispatching front end: the fused Triton kernel
    (ops/pallas_sim1.py) where the step is compiled for a CUDA GPU,
    the jnp reference `sim1_solver` on every other platform.  The
    choice is made per lowering platform, so one traced step serves
    both."""
    from ..ops.pallas_sim1 import sim1_solver_pallas

    return jax.lax.platform_dependent(
        dm, pt, dz, w, pem, pm, ws,
        cuda=lambda *a: sim1_solver_pallas(dt, *a, p_fac=p_fac),
        default=lambda *a: sim1_solver(dt, *a, p_fac),
    )


def sim1_solver(dt, dm, pt, dz, w, pem, pm, ws, p_fac: float = 0.05,
                unroll: int | bool = 1):
    """Fully implicit vertical acoustic solve for one substep.

    All arrays have the level axis at position 1: dm/pt/dz/w/pm are
    [6, nz, n, n] (or any [B, nz, ...]), pem is [6, nz+1, n, n]
    hydrostatic interface pressure, ws is [6, n, n].

    Returns (w2, dz2, ppe) with ppe the updated nonhydrostatic interface
    pressure perturbation [6, nz+1, n, n] (zero at the top).  `unroll`
    is passed to the three level scans (True: fully unrolled).
    """
    nz = dm.shape[1]
    lvl = lambda a: jnp.moveaxis(a, 1, 0)  # noqa: E731
    unlvl = lambda a: jnp.moveaxis(a, 0, 1)  # noqa: E731
    dm_l, pt_l, dz_l, w_l = lvl(dm), lvl(pt), lvl(dz), lvl(w)
    pem_l, pm_l = lvl(pem), lvl(pm)

    # layer pressure perturbation from the gas law
    pe_l = full_pressure(dm_l, pt_l, dz_l) - pm_l  # [nz, ...]

    # --- provisional interface perturbation (parabolic reconstruction,
    # forward elimination as in SIM1): rows couple (pp_k, pp_{k+1}) ----
    g_rat = dm_l[:-1] / dm_l[1:]  # [nz-1, ...]
    one = jnp.ones_like(pe_l[0])
    bb = jnp.concatenate(
        [2.0 * (1.0 + g_rat), 2.0 * one[None]], axis=0
    )
    dd = jnp.concatenate(
        [3.0 * (pe_l[:-1] + g_rat * pe_l[1:]), 3.0 * pe_l[-1:]], axis=0
    )
    g_rat_prev = jnp.concatenate([one[None], g_rat], axis=0)

    def pp_step(carry, x):
        bet, pp_k = carry
        bb_k, dd_k, gr_prev, first = x
        gam = jnp.where(first > 0.5, 0.0, gr_prev / bet)
        bet_new = bb_k - gam
        pp_next = (dd_k - pp_k) / bet_new
        return (bet_new, pp_next), pp_next

    first_flag = jnp.zeros((nz,)).at[0].set(1.0)
    (_, _), pp_rest = jax.lax.scan(
        pp_step,
        (jnp.full_like(one, 1.0), jnp.zeros_like(one)),
        (bb, dd, g_rat_prev, first_flag),
        unroll=unroll,
    )
    pp = jnp.concatenate([jnp.zeros_like(one)[None], pp_rest], axis=0)

    # --- implicit w (Thomas algorithm) --------------------------------
    t1g = 2.0 * GAMMA * dt * dt
    # interface stiffness, interfaces 1..nz-1 (dz < 0 so aa < 0)
    aa = t1g / (dz_l[:-1] + dz_l[1:]) * (pem_l[1:-1] + pp[1:-1])
    # bottom half-layer stiffness (surface reaction)
    p1 = t1g / dz_l[-1] * (pem_l[-1] + pp[-1])

    aa_up = jnp.concatenate([jnp.zeros_like(one)[None], aa], axis=0)
    aa_dn = jnp.concatenate([aa, p1[None]], axis=0)
    rhs = dm_l * w_l + dt * (pp[1:] - pp[:-1])
    rhs = rhs.at[-1].add(-p1 * ws)

    def fwd(carry, x):
        bet_prev, wp_prev, first = carry
        dm_k, a_up, a_dn, r = x
        gam = jnp.where(first > 0.5, jnp.zeros_like(a_up), a_up / bet_prev)
        bet = dm_k - (a_up + a_dn + a_up * gam)
        bet = jnp.where(first > 0.5, dm_k - a_dn, bet)
        wp = (r - a_up * wp_prev) / bet
        return (bet, wp, jnp.zeros_like(first)), (wp, gam)

    init = (jnp.ones_like(one), jnp.zeros_like(one), jnp.ones_like(one))
    _, (wp, gam) = jax.lax.scan(
        fwd, init, (dm_l, aa_up, aa_dn, rhs), unroll=unroll
    )

    def back(w_next, x):
        wp_k, gam_next = x
        w_k = wp_k - gam_next * w_next
        return w_k, w_k

    gam_next = jnp.concatenate([gam[1:], jnp.zeros_like(one)[None]], 0)
    _, w2_rev = jax.lax.scan(
        back, jnp.zeros_like(one), (wp[::-1], gam_next[::-1]),
        unroll=unroll,
    )
    w2 = w2_rev[::-1]

    # --- updated interface perturbation and new layer thickness -------
    dpe = dm_l * (w2 - w_l) / dt
    ppe = jnp.concatenate(
        [jnp.zeros_like(one)[None], jnp.cumsum(dpe, axis=0)], axis=0
    )
    p_lay = pm_l + (ppe[:-1] + 2.0 * ppe[1:]) / 3.0
    p_lay = jnp.maximum(p_lay, p_fac * pm_l)
    dz2 = dz_from_pressure(dm_l, pt_l, p_lay)

    return unlvl(w2), unlvl(dz2), unlvl(ppe)


def hydrostatic_dz(delp, pt, pe):
    """delz in exact discrete hydrostatic balance (rest-state init).

    delp [.., nz, ..], pt theta_v, pe interface pressures [.., nz+1, ..]
    with level axis 1.  Uses dz = -(R theta / g) * pi-layer-mean * dlnp
    consistency: p_full(dz) == layer-mean hydrostatic pressure.
    """
    pm = layer_mean_pressure(delp, pe)
    dm = delp / GRAV
    return dz_from_pressure(dm, pt, pm)


def layer_mean_pressure(delp, pe):
    """Exact mass-weighted layer pressure dp/dlnp (FV3's pm2)."""
    return delp / (jnp.log(pe[:, 1:]) - jnp.log(pe[:, :-1]))
