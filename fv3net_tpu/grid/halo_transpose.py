"""Exact transposes of the face-level staggered halo exchanges.

The provably-dissipative dampers (dycore/sw.py div_damp /
corner_div_damp) are built as M^T(W M) with jax.vjp; autodiff's
transpose of a table GATHER is a SCATTER-add, a serializing
full-field update.  The transpose of a
halo gather is itself expressible as gathers: every halo slot reads
exactly one pool entry, so grouping halo slots by source yields K
(small) inverse gather tables over the h-deep source band — forward
traffic, no scatters.

This module derives those inverse tables mechanically from the same
forward tables (grid/halo._dgrid_tables/_cgrid_tables) and registers
the exchange as a LINEAR PRIMITIVE (``ad.deflinear2``) so reverse-mode
autodiff uses the fast transpose while forward-mode (jacfwd, used by
the spectral-radius gates in tests/test_sw.py) still works — the
exchange is linear, so its jvp is the primitive itself.
(jax.custom_derivatives.linear_call was tried first: it has no
forward-mode rule; jax.custom_vjp would break jacfwd.)

Bit-compat: the transpose computes the same sums as autodiff's
scatter-add, up to float summation order (K-term where-sums instead
of scatter order); equality is asserted to f64 roundoff in
tests/test_halo_transpose.py.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def _halo_slots(rows_p, cols_p, h, rows, cols):
    """Enumerate padded halo positions (outside the interior crop) in
    the fixed strip order used by _strip_vector: S rows, N rows, W
    cols, E cols (faces major, C-order within each strip)."""
    slots = []
    for f in range(6):
        for j in range(0, h):
            for i in range(cols_p):
                slots.append((f, j, i))
    for f in range(6):
        for j in range(h + rows, rows_p):
            for i in range(cols_p):
                slots.append((f, j, i))
    for f in range(6):
        for j in range(h, h + rows):
            for i in range(0, h):
                slots.append((f, j, i))
    for f in range(6):
        for j in range(h, h + rows):
            for i in range(h + cols, cols_p):
                slots.append((f, j, i))
    return slots


def _strip_vector(ct, h, rows, cols):
    """Flatten the halo strips of a padded cotangent [..., R, C] into
    one [..., L] vector in the _halo_slots order."""
    def flat(x):  # [6, *lead, r, c] -> [*lead, 6*r*c], face-major
        x = jnp.moveaxis(x, 0, -3)
        return x.reshape(x.shape[:-3] + (-1,))

    s = flat(ct[..., :h, :])
    nn = flat(ct[..., h + rows :, :])
    w = flat(ct[..., h : h + rows, :h])
    e = flat(ct[..., h : h + rows, h + cols :])
    return jnp.concatenate([s, nn, w, e], axis=-1)


@lru_cache(maxsize=None)
def _inverse_tables(kind: str, n: int, h: int, fill: str = ""):
    """K inverse gather tables mapping halo-strip-vector positions back
    to pool (u then v flat) positions, grouped by source, PLUS the
    source band depth: every source lies within `depth` of an array
    edge, so the runtime gathers can be restricted to 4 edge
    rectangles per array (~16x less traffic than pool-sized gathers at
    C192, where the full-size form cost ~31 ms/step)."""
    from . import halo as _h

    if kind == "dgrid":
        (af, asg), (bf, bsg) = _h._dgrid_tables(n, h)
        rows_a, cols_a, rows_b, cols_b = n + 1, n, n, n + 1
    elif kind == "cgrid":
        (af, asg), (bf, bsg) = _h._cgrid_tables(n, h, fill)
        rows_a, cols_a, rows_b, cols_b = n, n + 1, n + 1, n
    else:
        raise ValueError(kind)
    af, asg = np.asarray(af), np.asarray(asg)
    bf, bsg = np.asarray(bf), np.asarray(bsg)
    size_a = 6 * rows_a * cols_a
    pool_size = size_a + 6 * rows_b * cols_b

    # H = [strips of a; strips of b]
    slots_a = _halo_slots(af.shape[1], af.shape[2], h, rows_a, cols_a)
    slots_b = _halo_slots(bf.shape[1], bf.shape[2], h, rows_b, cols_b)
    readers: dict = {}
    pos = 0
    for (f, j, i) in slots_a:
        if asg[f, j, i] != 0.0:
            readers.setdefault(int(af[f, j, i]), []).append(
                (pos, float(asg[f, j, i]))
            )
        pos += 1
    for (f, j, i) in slots_b:
        if bsg[f, j, i] != 0.0:
            readers.setdefault(int(bf[f, j, i]), []).append(
                (pos, float(bsg[f, j, i]))
            )
        pos += 1
    L = pos
    K = max((len(v) for v in readers.values()), default=1)
    inv_idx = np.zeros((K, pool_size), np.int32)
    inv_sgn = np.zeros((K, pool_size), np.float64)
    for src, lst in readers.items():
        for k, (p, s) in enumerate(lst):
            inv_idx[k, src] = p
            inv_sgn[k, src] = s

    # source band depth: max distance of any read source from its
    # array's nearest edge
    def depth_of(flat_local, rows, cols):
        f = flat_local // (rows * cols)
        rr = (flat_local % (rows * cols)) // cols
        cc = flat_local % cols
        del f
        return int(
            np.minimum(
                np.minimum(rr, rows - 1 - rr),
                np.minimum(cc, cols - 1 - cc),
            ).max()
        ) if flat_local.size else 0

    srcs = np.asarray(sorted(readers.keys()), np.int64)
    in_a = srcs < size_a
    depth = 0
    if in_a.any():
        depth = max(depth, depth_of(srcs[in_a], rows_a, cols_a))
    if (~in_a).any():
        depth = max(
            depth, depth_of(srcs[~in_a] - size_a, rows_b, cols_b)
        )
    return inv_idx, inv_sgn, size_a, L, K, depth + 1


def _staggered_transpose(kind, n, h, fill, up_ct, vp_ct, rows_a,
                         cols_a, rows_b, cols_b):
    inv_idx, inv_sgn, size_a, L, K, depth = _inverse_tables(
        kind, n, h, fill
    )
    dtype = up_ct.dtype
    Ha = _strip_vector(up_ct, h, rows_a, cols_a)
    Hb = _strip_vector(vp_ct, h, rows_b, cols_b)
    H = jnp.concatenate([Ha, Hb], axis=-1)
    lead = H.shape[:-1]

    def band_add(crop, offset, rows, cols):
        """crop + gathered contributions, restricted to the 4 edge
        rectangles of depth `depth` (sources never lie deeper).  On
        faces small enough that the bands would overlap or miss the
        middle row/col, fall back to one full-array rectangle."""
        d = min(depth, rows // 2, cols // 2)
        if 2 * depth >= rows or 2 * depth >= cols:
            d = 0  # full-array single rectangle below
        flat = (
            np.arange(6)[:, None, None] * (rows * cols)
            + np.arange(rows)[None, :, None] * cols
            + np.arange(cols)[None, None, :]
            + offset
        )

        def rect_add(own, rs, cs):
            sub = flat[:, rs, cs]  # [6, R, C]
            add = jnp.zeros(
                lead + sub.shape, dtype
            )
            for k in range(K):
                idxk = inv_idx[k][sub]
                sgnk = inv_sgn[k][sub]
                if not sgnk.any():
                    continue
                add = add + jnp.take(
                    H, jnp.asarray(idxk.reshape(-1)), axis=-1
                ).reshape(lead + sub.shape) * jnp.asarray(
                    sgnk, dtype
                )
            # [*lead, 6, R, C] -> [6, *lead, R, C]
            add = jnp.moveaxis(add, len(lead), 0)
            return own + add

        if d == 0:
            return rect_add(crop, np.s_[:], np.s_[:])
        top = rect_add(
            crop[..., :d, :], np.s_[:d], np.s_[:]
        )
        bot = rect_add(
            crop[..., rows - d :, :], np.s_[rows - d :], np.s_[:]
        )
        left = rect_add(
            crop[..., d : rows - d, :d], np.s_[d : rows - d],
            np.s_[:d],
        )
        right = rect_add(
            crop[..., d : rows - d, cols - d :],
            np.s_[d : rows - d], np.s_[cols - d :],
        )
        mid = jnp.concatenate(
            [left, crop[..., d : rows - d, d : cols - d], right],
            axis=-1,
        )
        return jnp.concatenate([top, mid, bot], axis=-2)

    u_ct = band_add(
        up_ct[..., h : h + rows_a, h : h + cols_a], 0, rows_a, cols_a
    )
    v_ct = band_add(
        vp_ct[..., h : h + rows_b, h : h + cols_b], size_a, rows_b,
        cols_b,
    )
    return u_ct, v_ct


# ---------------------------------------------------------------------
# The exchanges as true LINEAR primitives: jvp is the primitive itself
# (so jacfwd — the sw spectral-radius gates — works untouched) and the
# transpose is the gather-based rule above (so vjp-built dampers avoid
# scatters).  jax.custom_derivatives.linear_call has no forward-mode
# rule, hence the explicit primitive.
# ---------------------------------------------------------------------

from jax.extend import core as jex_core  # noqa: E402
from jax.interpreters import ad, batching, mlir  # noqa: E402


def _shapes(kind, n, h):
    if kind == "dgrid":
        rows_a, cols_a, rows_b, cols_b = n + 1, n, n, n + 1
    else:
        rows_a, cols_a, rows_b, cols_b = n, n + 1, n + 1, n
    return rows_a, cols_a, rows_b, cols_b


def _impl(u, v, *, kind, n, h, fill):
    from . import halo as _h

    if kind == "dgrid":
        tables = _h._dgrid_tables(n, h)
        plan = _h._dgrid_affine_plans(n, h)
    else:
        tables = _h._cgrid_tables(n, h, fill)
        plan = _h._cgrid_affine_plans(n, h, fill)
    ra, ca, rb, cb = _shapes(kind, n, h)
    return _h._staggered_strip_exchange(
        u, v, tables, h, ra, ca, rb, cb, u.dtype, plan
    )


_exchange_p = jex_core.Primitive("staggered_halo_exchange")
_exchange_p.multiple_results = True


@_exchange_p.def_impl
def _exchange_impl(u, v, *, kind, n, h, fill):
    return list(_impl(u, v, kind=kind, n=n, h=h, fill=fill))


@_exchange_p.def_abstract_eval
def _exchange_abstract(u, v, *, kind, n, h, fill):
    ra, ca, rb, cb = _shapes(kind, n, h)
    lead = u.shape[1:-2]
    return [
        jax.core.ShapedArray(
            (6,) + lead + (ra + 2 * h, ca + 2 * h), u.dtype
        ),
        jax.core.ShapedArray(
            (6,) + lead + (rb + 2 * h, cb + 2 * h), v.dtype
        ),
    ]


mlir.register_lowering(
    _exchange_p,
    mlir.lower_fun(
        lambda u, v, *, kind, n, h, fill: _impl(
            u, v, kind=kind, n=n, h=h, fill=fill
        ),
        multiple_results=True,
    ),
)


def _exchange_transpose(cts, u, v, *, kind, n, h, fill):
    ra, ca, rb, cb = _shapes(kind, n, h)
    up_ct, vp_ct = cts
    if type(up_ct) is ad.Zero:
        up_ct = jnp.zeros(up_ct.aval.shape, up_ct.aval.dtype)
    if type(vp_ct) is ad.Zero:
        vp_ct = jnp.zeros(vp_ct.aval.shape, vp_ct.aval.dtype)
    u_ct, v_ct = _staggered_transpose(
        kind, n, h, fill, up_ct, vp_ct, ra, ca, rb, cb
    )
    return [u_ct, v_ct]


ad.deflinear2(_exchange_p, _exchange_transpose)


def _exchange_batcher(args, dims, *, kind, n, h, fill):
    u, v = args
    du, dv = dims
    # move batch axes into the lead block (between face and spatial)
    if du is batching.not_mapped:
        size = v.shape[dv]
        u = jnp.broadcast_to(
            u[:, None], u.shape[:1] + (size,) + u.shape[1:]
        )
    else:
        u = jnp.moveaxis(u, du, 1)
    if dv is batching.not_mapped:
        size = args[0].shape[du]
        v = jnp.broadcast_to(
            v[:, None], v.shape[:1] + (size,) + v.shape[1:]
        )
    else:
        v = jnp.moveaxis(v, dv, 1)
    out = _exchange_p.bind(u, v, kind=kind, n=n, h=h, fill=fill)
    return out, (1, 1)


batching.primitive_batchers[_exchange_p] = _exchange_batcher


def dgrid_exchange_linear(u, v, h: int):
    """halo_exchange_dgrid as a linear primitive with fast transpose."""
    n = u.shape[-1]
    return tuple(
        _exchange_p.bind(u, v, kind="dgrid", n=n, h=h, fill="")
    )


def cgrid_exchange_linear(uc, vc, h: int, fill: str):
    """halo_exchange_cgrid as a linear primitive with fast transpose."""
    n = uc.shape[-2]
    return tuple(
        _exchange_p.bind(uc, vc, kind="cgrid", n=n, h=h, fill=fill)
    )
