"""Fused Pallas (Triton route) kernel for the semi-implicit vertical solver.

The jnp `dycore.riemann.sim1_solver` (FV3's SIM1_solver role,
`a_imp: 1.0` in the reference namelist,
workflows/prognostic_c48_run/tests/test_regression.py:133-200) runs
three `lax.scan`s and a cumsum over the levels; compiled for the GPU
each scan iteration is its own small kernel over all 6*n*n columns.

This kernel gives one program to each run of `block` columns along the
contiguous (y*x) axis and walks the levels inside the program:

1. forward: gas-law pressure, the bidiagonal pp sweep and the Thomas
   forward elimination in one pass (pp_{k+1} is all that level k's
   stiffness and right-hand side need), writing the provisional w and
   the elimination coefficients gam -- an extra output that stays in
   L2 until the back sweep reads it;
2. backward: the Thomas back substitution into w2;
3. forward: the ppe prefix sum and the new layer thickness.

Masked loads and stores cover the ragged last block, so any width runs.
Semantics are those of `sim1_solver` (tests/test_pallas_kernels.py
compares the two in interpret mode).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..dycore.riemann import GAMMA, dz_from_pressure, full_pressure

# columns per program: a power of two for Triton; 64 columns are two
# warps with one column per thread, enough programs (216 at C48) to
# spread over the card's 132 SMs
BLOCK = 64


def _sim1_kernel(dm_ref, pt_ref, dz_ref, w_ref, pem_ref, pm_ref, ws_ref,
                 w2_ref, dz2_ref, ppe_ref, gam_ref,
                 *, dt: float, nz: int, p_fac: float, block: int,
                 sync: bool):
    f = pl.program_id(0)
    cols = pl.program_id(1) * block + jnp.arange(block)
    mask = cols < dm_ref.shape[-1]

    def ld(ref, k):
        return plgpu.load(ref.at[f, k, cols], mask=mask)

    def st(ref, k, val):
        plgpu.store(ref.at[f, k, cols], val, mask=mask)

    def pe_at(k, dm):
        return full_pressure(dm, ld(pt_ref, k), ld(dz_ref, k)) - ld(
            pm_ref, k
        )

    t1g = 2.0 * GAMMA * dt * dt
    ws = plgpu.load(ws_ref.at[f, cols], mask=mask)

    # --- pass 1: pp sweep + Thomas forward elimination ------------------
    # carry: level-k inputs (dm, pe, dz), pp_k, the pp sweep's (bet,
    # g_rat_{k-1}), the stiffness above level k and the Thomas (bet, wp).
    # The first level's "previous" values (g_rat 0, bet 1, a_up 0) make
    # its coefficients come out exactly as the reference's first row.
    def level(k, carry, last: bool):
        dm, pe, dz, pp, bet_pp, gr_prev, a_up, bet, wp = carry
        if last:
            bb = 2.0
            dd = 3.0 * pe
        else:
            dm1 = ld(dm_ref, k + 1)
            pe1 = pe_at(k + 1, dm1)
            dz1 = ld(dz_ref, k + 1)
            g_rat = dm / dm1
            bb = 2.0 * (1.0 + g_rat)
            dd = 3.0 * (pe + g_rat * pe1)
        bet_pp = bb - gr_prev / bet_pp
        pp1 = (dd - pp) / bet_pp
        rhs = dm * ld(w_ref, k) + dt * (pp1 - pp)
        if last:
            a_dn = t1g / dz * (ld(pem_ref, nz) + pp1)
            rhs = rhs - a_dn * ws
        else:
            a_dn = t1g / (dz + dz1) * (ld(pem_ref, k + 1) + pp1)
        gam = a_up / bet
        bet = dm - (a_up + a_dn + a_up * gam)
        wp = (rhs - a_up * wp) / bet
        st(w2_ref, k, wp)
        st(gam_ref, k, gam)
        if last:
            return wp
        return (dm1, pe1, dz1, pp1, bet_pp, g_rat, a_dn, bet, wp)

    dm0 = ld(dm_ref, 0)
    zero = jnp.zeros_like(dm0)
    one = jnp.ones_like(dm0)
    carry = (dm0, pe_at(0, dm0), ld(dz_ref, 0), zero, one, zero, zero,
             one, zero)
    carry = jax.lax.fori_loop(
        0, nz - 1, functools.partial(level, last=False), carry
    )
    w_bottom = level(nz - 1, carry, last=True)
    # each pass re-reads what the previous one stored; the barrier makes
    # those stores visible across the block's threads (the interpreter
    # runs a block as one array program and has no barrier)
    if sync:
        plgpu.debug_barrier()

    # --- pass 2: Thomas back substitution --------------------------------
    def back(i, w_next):
        k = nz - 2 - i
        w_k = ld(w2_ref, k) - ld(gam_ref, k + 1) * w_next
        st(w2_ref, k, w_k)
        return w_k

    jax.lax.fori_loop(0, nz - 1, back, w_bottom)
    if sync:
        plgpu.debug_barrier()

    # --- pass 3: interface perturbation prefix sum + new thickness -------
    st(ppe_ref, 0, zero)

    def thickness(k, ppe):
        dm = ld(dm_ref, k)
        pm = ld(pm_ref, k)
        ppe1 = ppe + dm * (ld(w2_ref, k) - ld(w_ref, k)) / dt
        st(ppe_ref, k + 1, ppe1)
        p_lay = jnp.maximum(pm + (ppe + 2.0 * ppe1) / 3.0, p_fac * pm)
        st(dz2_ref, k, dz_from_pressure(dm, ld(pt_ref, k), p_lay))
        return ppe1

    jax.lax.fori_loop(0, nz, thickness, zero)


@functools.partial(jax.jit, static_argnames=("dt", "p_fac", "interpret"))
def sim1_solver_pallas(dt, dm, pt, dz, w, pem, pm, ws,
                       p_fac: float = 0.05, interpret: bool = False):
    """Drop-in fused replacement for dycore.riemann.sim1_solver.

    Arrays [F, nz, ny, nx] (pem [F, nz+1, ny, nx], ws [F, ny, nx]),
    level axis 1.  Returns (w2, dz2, ppe).
    """
    F, nz, ny, nx = dm.shape
    ncol = ny * nx

    def cols(a):
        return a.reshape(a.shape[:-2] + (ncol,))

    # under shard_map the outputs vary over the same mesh axes as dm
    vma = getattr(jax.typeof(dm), "vma", None)

    def out(*shape):
        return jax.ShapeDtypeStruct(shape, dm.dtype, vma=vma)

    lay = out(F, nz, ncol)
    w2, dz2, ppe, _ = pl.pallas_call(
        functools.partial(
            _sim1_kernel, dt=float(dt), nz=nz, p_fac=p_fac, block=BLOCK,
            sync=not interpret,
        ),
        grid=(F, pl.cdiv(ncol, BLOCK)),
        out_shape=(lay, lay, out(F, nz + 1, ncol), lay),
        compiler_params=plgpu.CompilerParams(num_warps=BLOCK // 32),
        backend="triton",
        interpret=interpret,
        name="sim1_solver",
    )(*map(cols, (dm, pt, dz, w, pem, pm, ws)))
    shape = dm.shape
    return (
        w2.reshape(shape), dz2.reshape(shape),
        ppe.reshape(pem.shape),
    )
