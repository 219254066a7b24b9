"""Horizontal finite-volume transport operators (fv_tp_2d equivalent).

The 2D flux-form advection scheme of the FV3 dycore: directionally-split
1D PPM operators combined with Lin & Rood (1996) inner/outer averaging so
the splitting error cancels to second order.  This is the JAX
equivalent of the reference dycore's ``fv_tp_2d``/``xppm``/``yppm``
(FV3GFS tp_core.F90; not in the reference tree -- the submodule is empty
-- so the scheme is implemented from its published formulation and
validated by conservation/monotonicity/rotation tests).

hord selects the edge reconstruction/limiter:
    1: first-order upwind (piecewise constant)
    5: unlimited PPM (fastest, non-monotone)
    6: PPM with a quasi-monotone (Huynh-style) constraint
    8: strictly monotone PPM (Lin 2004 slope-bounded edges)

All operators work on fully padded cube arrays [6, ..., n+2h, n+2h]
(h >= 3) produced by grid.halo.halo_exchange with the appropriate corner
fill, and return fluxes on the padded face lattice so the Lin-Rood inner
stage can consume halo-row fluxes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _ppm_edges(q, axis: int, hord: int):
    """Left/right edge values and curvature per cell along `axis`.

    Cells within 2 of the array boundary get garbage (consumed only if
    the caller's halo is too small -- callers must pass h >= 3).
    Returns (al, ar, a6) with al[i] the edge value between cells i-1,i.
    """

    def sh(k):
        return jnp.roll(q, -k, axis=axis)

    qm2, qm1, q0, qp1 = sh(-2), sh(-1), q, sh(1)
    if hord == 1:
        return q0, q0, jnp.zeros_like(q0)

    # uniform 4th-order edge interpolation (FV3 tp_core coefficients)
    al = (7.0 / 12.0) * (qm1 + q0) - (1.0 / 12.0) * (qm2 + qp1)
    ar = jnp.roll(al, -1, axis=axis)  # al of cell i+1 = right edge of i

    if hord == 5:
        a6 = 3.0 * (2.0 * q0 - (al + ar))
        return al, ar, a6

    # limited slope (van Leer / mono-constrained)
    dqm = q0 - qm1
    dqp = qp1 - q0
    df2 = 0.25 * (qp1 - qm1)
    dm = jnp.sign(df2) * jnp.minimum(
        jnp.abs(2.0 * df2),
        jnp.minimum(
            jnp.abs(jnp.maximum(jnp.maximum(qm1, q0), qp1) - q0),
            jnp.abs(q0 - jnp.minimum(jnp.minimum(qm1, q0), qp1)),
        ),
    )

    if hord == 8:
        # strictly monotone: edge increments bounded by the limited slope
        bl = -jnp.sign(dm) * jnp.minimum(jnp.abs(2.0 * dm),
                                         jnp.abs(al - q0))
        br = jnp.sign(dm) * jnp.minimum(jnp.abs(2.0 * dm),
                                        jnp.abs(ar - q0))
        al8 = q0 + bl
        ar8 = q0 + br
        a6 = 3.0 * (2.0 * q0 - (al8 + ar8))
        return al8, ar8, a6

    if hord == 6:
        # quasi-monotone: clamp edges into the local neighborhood range
        lo = jnp.minimum(jnp.minimum(qm1, q0), qp1)
        hi = jnp.maximum(jnp.maximum(qm1, q0), qp1)
        al6 = jnp.clip(al, lo, hi)
        ar6 = jnp.clip(ar, lo, hi)
        a6 = 3.0 * (2.0 * q0 - (al6 + ar6))
        return al6, ar6, a6

    raise ValueError(f"unsupported hord {hord}")


def ppm_flux(q, cr, axis: int, hord: int):
    """Upwind PPM face-average of q for Courant numbers cr.

    q: padded cell array; cr: Courant number AT THE FACE between cells
    i-1 and i, stored at index i of an array the same length as q along
    `axis` (entry 0 invalid).  Returns the face average (the "advected
    q" to be multiplied by a mass flux), same shape as q, entry i =
    value at face i (between cells i-1 and i); entries near the array
    ends are garbage.
    """
    al, ar, a6 = _ppm_edges(q, axis, hord)

    def sh(a, k):
        return jnp.roll(a, -k, axis=axis)

    # face i: upwind cell i-1 when cr > 0 (flow toward +axis), else cell i
    c = cr
    # from cell i-1 (use its right-edge region): integrate s in [1-c, 1]
    arm = sh(ar, -1)
    alm = sh(al, -1)
    a6m = sh(a6, -1)
    qup = arm - 0.5 * c * (
        (arm - alm) - a6m * (1.0 - (2.0 / 3.0) * c)
    )
    # from cell i (c < 0): integrate s in [0, |c|]
    b = -c
    qdn = al + 0.5 * b * ((ar - al) + a6 * (1.0 - (2.0 / 3.0) * b))
    return jnp.where(c > 0.0, qup, qdn)


@jax.named_scope("transport")
def fv_tp_2d(qp_x, qp_y, crx, cry, xfx, yfx, area_px, area_py, hord: int):
    """2D Lin-Rood flux-form transport on the padded cube.

    Args:
        qp_x: q padded with fill='x' corners (consumed by x-stencils)
        qp_y: q padded with fill='y' corners (consumed by y-stencils)
        crx: Courant numbers at x-faces, padded face lattice: entry
            [..., j, i] = face between cells (j, i-1) and (j, i); same
            array shape as qp (last column unused); must carry fill='x'
            consistent corner values (halo_exchange_cgrid)
        cry: Courant numbers at y-faces (same convention along axis -2),
            fill='y' corners
        xfx: mass flux through x-faces (same layout/fill as crx); the
            flux returned is `face-average(q) * xfx`
        yfx: mass flux through y-faces (fill like cry)
        area_px: padded cell areas, corner fill 'x'
        area_py: padded cell areas, corner fill 'y'
        hord: reconstruction order/limiter

    Returns:
        (fx, fy): mass-weighted q fluxes on the padded face lattices.
        Valid on interior faces; the caller forms
        q_new = (q*area*delp_old + div(f))/ (area*delp_new).

    Follows the fv_tp_2d structure: an inner conservative update in the
    transverse direction (divided by the transversely-updated air mass)
    feeds the outer flux computation, cancelling the splitting error.
    """
    def shx(a, k):
        return jnp.roll(a, -k, axis=-1)

    def shy(a, k):
        return jnp.roll(a, -k, axis=-2)

    # inner HALF update in the transverse direction -> outer fluxes; the
    # half factor is what cancels the splitting cross-term to second
    # order and keeps the 2-delta modes neutral (Lin & Rood 1996; a full
    # inner update has von Neumann amplification ~5 at the Nyquist mode)
    fy2 = ppm_flux(qp_y, cry, -2, hord) * yfx
    ra_y = area_py + (yfx - shy(yfx, 1))
    q_y = 0.5 * (qp_y + (qp_y * area_py + (fy2 - shy(fy2, 1))) / ra_y)

    fx2 = ppm_flux(qp_x, crx, -1, hord) * xfx
    ra_x = area_px + (xfx - shx(xfx, 1))
    q_x = 0.5 * (qp_x + (qp_x * area_px + (fx2 - shx(fx2, 1))) / ra_x)

    fx = ppm_flux(q_y, crx, -1, hord) * xfx
    fy = ppm_flux(q_x, cry, -2, hord) * yfx
    return fx, fy
