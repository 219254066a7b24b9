"""Single-device halo exchange on full-cube arrays.

Fields live on the full cube as ``[6, ..., n, n]`` arrays; the exchange
produces padded ``[6, ..., n+2h, n+2h]`` arrays whose edge halos hold the
neighboring faces' interior values with the correct inter-face index
rotation (and component rotation for vectors).  All index tables are
precomputed in numpy (setup time) and baked into the jitted computation as
constants, so the exchange compiles to static gathers.

This mirrors what the reference achieves with FMS ``mpp_update_domains``
(L0, via MPI) and `pace.util` halo updates on the Python side
(fv3fit/keras/_models/shared/halos.py:10-60) -- here it is a pure function
so XLA can fuse and the multi-device version (parallel/halo.py) can reuse
the same tables for device collectives.

Vector semantics: D-grid staggered winds are edge-tangential components;
across a face boundary an edge is the same physical segment, so the halo
value is the neighbor's stored value up to a sign (direction reversal) and
a u<->v swap (quarter-turn index rotation).  The index maps are derived
from the shared corner lattice, which makes the corner cases (literal cube
corners) fall out of the derivation instead of hand-coded tables.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from . import topology as topo

# When set (grid.halo.spmd_mode), the public exchange functions
# dispatch to the shard-local ppermute implementations in
# parallel/halo_spmd.py -- the same numerical definition, executed as
# neighbor exchanges over the mesh's face axis instead of full-cube
# gathers.  This is what lets the dycore run unchanged inside
# shard_map (parallel/spmd_dycore.py).  With a TileLayout (tiling=...)
# the dispatch goes to the within-face tiled plans
# (parallel/tiling.py) over the flattened (face, y, x) mesh axes.
_SPMD_AXIS = None
_SPMD_TILING = None


@contextlib.contextmanager
def spmd_mode(axis: str = "face", tiling=None):
    global _SPMD_AXIS, _SPMD_TILING
    prev = (_SPMD_AXIS, _SPMD_TILING)
    _SPMD_AXIS = axis
    _SPMD_TILING = tiling
    try:
        yield
    finally:
        _SPMD_AXIS, _SPMD_TILING = prev


@lru_cache(maxsize=None)
def _scalar_tables(n: int, h: int, fill: str = "none"):
    if fill == "none":
        src_face, src_j, src_i, corner_mask = topo.halo_source_indices(n, h)
    else:
        src_face, src_j, src_i, corner_mask = (
            topo.halo_source_indices_filled(n, h, fill)
        )
    flat = (src_face * n + src_j) * n + src_i
    return flat, corner_mask


@lru_cache(maxsize=None)
def _scalar_strip_tables(n: int, h: int, fill: str):
    """Strip-form gather tables: south/north blocks (full padded width,
    corners included) and west/east strips (interior rows only).  The
    exchange then reads only the halo ring from HBM instead of
    gathering the whole field (5-30x less traffic at C48-C384)."""
    flat, _ = _scalar_tables(n, h, fill)
    south = flat[:, :h, :]  # [6, h, N]
    north = flat[:, h + n :, :]
    west = flat[:, h : h + n, :h]  # [6, n, h]
    east = flat[:, h : h + n, h + n :]
    # NOTE: cache numpy, not jnp -- a jnp constant materialized inside
    # a jit trace would be cached as a tracer and leak into later traces
    return (
        south.astype(np.int32),
        north.astype(np.int32),
        west.astype(np.int32),
        east.astype(np.int32),
    )


def _halo_blocks(n: int, h: int):
    """The 8 halo blocks of the padded [N, N] array (N = n + 2h)."""
    N = n + 2 * h
    return {
        "S": (slice(0, h), slice(h, h + n)),
        "N": (slice(h + n, N), slice(h, h + n)),
        "W": (slice(h, h + n), slice(0, h)),
        "E": (slice(h, h + n), slice(h + n, N)),
        "SW": (slice(0, h), slice(0, h)),
        "SE": (slice(0, h), slice(h + n, N)),
        "NW": (slice(h + n, N), slice(0, h)),
        "NE": (slice(h + n, N), slice(h + n, N)),
    }


@lru_cache(maxsize=None)
def _scalar_affine_plan(n: int, h: int, fill: str):
    """Compile the scalar halo tables into slice/flip/transpose op
    trees (ops.affine_gather): per receiver face, per halo block."""
    from ..ops import affine_gather as ag

    if fill == "none":
        src_face, src_j, src_i, _ = topo.halo_source_indices(n, h)
    else:
        src_face, src_j, src_i, _ = topo.halo_source_indices_filled(
            n, h, fill
        )
    seg = np.zeros_like(src_face)
    sign = np.ones(src_face.shape)
    plan = {}
    for name, (rs, cs) in _halo_blocks(n, h).items():
        plan[name] = tuple(
            ag.compile_block(
                seg[f, rs, cs], src_face[f, rs, cs],
                src_j[f, rs, cs], src_i[f, rs, cs],
                sign[f, rs, cs], widths=(n,),
            )
            for f in range(6)
        )
    return plan


# Faces up to this size use the affine slice/flip-compiled exchanges,
# larger faces the strip gathers (identical outputs).  At C192x63 on an
# H100 80GB HBM3 (700 W) the strip-gather step is the faster one:
# 160.7 ms against 195.4 ms with the affine form, which also took
# 126.8 s to compile (tools/profile_step.py setup 192).
AFFINE_MAX_N = 96


def _halo_exchange_gather(field, h: int, fill: str):
    """Strip-form flat-gather scalar exchange (pre-affine path; used
    for faces above AFFINE_MAX_N)."""
    n = field.shape[-1]
    south, north, west, east = _scalar_strip_tables(n, h, fill)
    src = jnp.moveaxis(field, 0, -3)  # [..., 6, n, n]
    flat = src.reshape(src.shape[:-3] + (6 * n * n,))

    def take(tbl):
        return jnp.take(flat, jnp.asarray(tbl), axis=-1)

    s, nn_, w, e = take(south), take(north), take(west), take(east)
    mid = jnp.concatenate([w, src, e], axis=-1)
    out = jnp.concatenate([s, mid, nn_], axis=-2)
    return jnp.moveaxis(out, -3, 0)


def halo_exchange(field, h: int, fill: str = "none"):
    """Pad a cell-centered scalar [6, ..., n, n] with h halo cells.

    fill='none': cube-corner halo slots get the nearest edge value
    (clipped index) and must not be consumed by stencils.
    fill='x' / 'y': corner slots are resolved to the true third-face
    cells by row / column continuation -- the cube-topology-exact
    version of FV3's copy_corners(dir=1/2) (tp_core.F90); use 'y' before
    y-direction stencils that run on x-halo columns and vice versa.

    Implementation: interior is a pass-through; the halo ring is
    assembled from the gather tables COMPILED to slice/flip/transpose
    copies (ops.affine_gather) for n <= AFFINE_MAX_N -- bit-identical
    to the flat gather at memcpy speed -- and as strip gathers above
    (see AFFINE_MAX_N).
    """
    if _SPMD_TILING is not None:
        from ..parallel import tiling as _tl

        return _tl.halo_exchange_tiled(field, _SPMD_TILING, fill)
    if _SPMD_AXIS is not None:
        from ..parallel import halo_spmd as _hs

        return _hs.halo_exchange_local(field, h, fill, _SPMD_AXIS)
    from ..ops import affine_gather as ag

    n = field.shape[-1]
    if n > AFFINE_MAX_N:
        return _halo_exchange_gather(field, h, fill)
    plan = _scalar_affine_plan(n, h, fill)
    srcs = ([field[g] for g in range(6)],)
    lead = field.shape[1:-2]
    dtype = field.dtype

    def blk(name, g):
        return ag.apply_block(srcs, plan[name][g], dtype, lead)

    outs = []
    for g in range(6):
        mid = jnp.concatenate(
            [blk("W", g), field[g], blk("E", g)], axis=-1
        )
        bot = jnp.concatenate(
            [blk("SW", g), blk("S", g), blk("SE", g)], axis=-1
        )
        top = jnp.concatenate(
            [blk("NW", g), blk("N", g), blk("NE", g)], axis=-1
        )
        outs.append(jnp.concatenate([bot, mid, top], axis=-2))
    return jnp.stack(outs, axis=0)


@lru_cache(maxsize=None)
def _agrid_vector_tables(n: int, h: int):
    """Rotation coefficient tables for A-grid vector halo exchange."""
    np_sz = n + 2 * h
    m00 = np.ones((6, np_sz, np_sz))
    m01 = np.zeros((6, np_sz, np_sz))
    m10 = np.zeros((6, np_sz, np_sz))
    m11 = np.ones((6, np_sz, np_sz))
    for f in range(6):
        for e in range(4):
            l = topo.link(f, e)
            r = l.rot
            c, s = [(1, 0), (0, 1), (-1, 0), (0, -1)][r]
            # M = [[c, -s], [s, c]] maps neighbor (u,v) -> ours
            if e == topo.EDGE_W:
                sl = np.s_[f, h : h + n, 0:h]
            elif e == topo.EDGE_E:
                sl = np.s_[f, h : h + n, h + n :]
            elif e == topo.EDGE_S:
                sl = np.s_[f, 0:h, h : h + n]
            else:
                sl = np.s_[f, h + n :, h : h + n]
            m00[sl], m01[sl], m10[sl], m11[sl] = c, -s, s, c
    return m00, m01, m10, m11


def extend_cells_one(field):
    """Pad a cell-centered field [6(or L), ..., n, n] by ONE ghost cell
    per side WITHIN the face: plain edge replication at face level (and
    at true face boundaries under tiling), neighbor-tile cells at
    within-face tile boundaries.  Bit-preserving contract: at face
    level this is exactly jnp.pad(mode='edge'), so one-sided boundary
    formulas written as 0.5*(ext[j] + ext[j+1]) reproduce their
    pre-extension bits (0.5*(x+x) == x)."""
    if _SPMD_TILING is not None:
        from ..parallel import tiling as _tl

        return _tl.extend_cells_one_tiled(field, _SPMD_TILING)
    pad = [(0, 0)] * (field.ndim - 2) + [(1, 1), (1, 1)]
    return jnp.pad(field, pad, mode="edge")


def halo_exchange_vector_cgrid(u, v, h: int):
    """Halo-exchange an A-grid (cell-centered) vector with rotation.

    u, v: [6, ..., n, n] components along the face-local x / y directions.
    Returns padded (u, v) with halo components rotated into this face's
    frame.
    """
    n = u.shape[-1]
    up = halo_exchange(u, h)
    vp = halo_exchange(v, h)
    m00, m01, m10, m11 = _agrid_vector_tables(n, h)
    uo = jnp.asarray(m00) * up + jnp.asarray(m01) * vp
    vo = jnp.asarray(m10) * up + jnp.asarray(m11) * vp
    return uo, vo


def _quantize(xyz: np.ndarray) -> np.ndarray:
    """Quantize unit-sphere coords to integers for exact matching."""
    return np.round(xyz * 1e9).astype(np.int64)


@lru_cache(maxsize=None)
def _dgrid_tables(n: int, h: int):
    """Gather tables for D-grid staggered wind halo exchange.

    u[J, i] lives on the x-directed edge between corners (J, i), (J, i+1):
    shape (n+1, n).  v[j, I] on the y-directed edge between corners (j, I),
    (j+1, I): shape (n, n+1).  Across a face boundary an edge is the same
    physical great-circle segment, so we match halo edge positions to
    stored edges geometrically: each edge is keyed by the quantized xyz of
    its (unordered) corner pair; the sign is +1 when the stored direction
    agrees with the query direction.  This derivation makes every corner
    case (including edges straddling the face boundary and the literal
    cube corners) fall out automatically.
    """
    from .geometry import extended_corners, gnomonic_grid

    base = gnomonic_grid(n)  # [6, n+1, n+1, 3]
    ext = extended_corners(n, h)  # [6, n+2h+1, n+2h+1, 3] (NaN corners)
    nu = (n + 1) * n  # one face's u count; v entries offset by 6*nu

    # Build lookup: quantized (unordered corner pair) -> (flat pool index,
    # quantized "from" corner).  Shared-boundary edges are stored by two
    # faces; first writer wins (values are consistent by construction).
    table = {}

    def store(kind, g, a_idx, b_idx, A, B):
        ka, kb = tuple(_quantize(A)), tuple(_quantize(B))
        key = (ka, kb) if ka <= kb else (kb, ka)
        if key in table:
            return
        if kind == "u":
            flat = (g * (n + 1) + a_idx) * n + b_idx
        else:
            flat = 6 * nu + (g * n + a_idx) * (n + 1) + b_idx
        table[key] = (flat, ka)

    for g in range(6):
        for J in range(n + 1):
            for i in range(n):
                store("u", g, J, i, base[g, J, i], base[g, J, i + 1])
        for j in range(n):
            for I in range(n + 1):
                store("v", g, j, I, base[g, j, I], base[g, j + 1, I])

    def build(kind: str):
        if kind == "u":
            shp = (6, n + 2 * h + 1, n + 2 * h)
        else:
            shp = (6, n + 2 * h, n + 2 * h + 1)
        flat = np.zeros(shp, dtype=np.int64)
        sign = np.zeros(shp, dtype=np.float64)
        for f in range(6):
            for a in range(shp[1]):
                for b in range(shp[2]):
                    # own lattice positions (interior AND own boundary)
                    # pass through identically -- the exchange must never
                    # overwrite a face's own stored edge values.
                    if kind == "u":
                        own = h <= a <= h + n and h <= b < h + n
                    else:
                        own = h <= a < h + n and h <= b <= h + n
                    if own:
                        if kind == "u":
                            flat[f, a, b] = (f * (n + 1) + (a - h)) * n + (
                                b - h
                            )
                        else:
                            flat[f, a, b] = (
                                6 * nu + (f * n + (a - h)) * (n + 1) + (b - h)
                            )
                        sign[f, a, b] = 1.0
                        continue
                    if kind == "u":
                        A, B = ext[f, a, b], ext[f, a, b + 1]
                    else:
                        A, B = ext[f, a, b], ext[f, a + 1, b]
                    if not (np.isfinite(A).all() and np.isfinite(B).all()):
                        continue
                    ka, kb = tuple(_quantize(A)), tuple(_quantize(B))
                    key = (ka, kb) if ka <= kb else (kb, ka)
                    hit = table.get(key)
                    if hit is None:
                        continue
                    idx, stored_from = hit
                    flat[f, a, b] = idx
                    sign[f, a, b] = 1.0 if stored_from == ka else -1.0
        return flat, sign

    return build("u"), build("v")


def _rot_matrix(rot: int) -> np.ndarray:
    c, s = [(1, 0), (0, 1), (-1, 0), (0, -1)][rot]
    return np.array([[c, -s], [s, c]])


@lru_cache(maxsize=None)
def _cgrid_tables(n: int, h: int, fill: str):
    """Gather tables for C-grid (face-normal) staggered fields.

    uc [6, n, n+1]: x-component stored on x-faces (between cells (j,i-1)
    and (j,i), face index i); vc [6, n+1, n]: y-component on y-faces.
    Used for C-grid winds, Courant numbers and mass fluxes.

    Slots are resolved through the neighbor charts via the affine edge
    maps; the component sign/swap comes from the chart rotation matrix.
    Cube-corner slots are resolved by chart composition, ordered so the
    value equals bit-for-bit what the strip-owning neighbor holds in its
    own (single-map) halo -- the property that makes shared-edge fluxes
    cancel exactly and keeps global mass conservation to roundoff.
    fill='x' orders the composition for fields consumed by x-direction
    stencils (first through the y-neighbor), 'y' the transpose.
    """
    assert fill in ("x", "y")
    first = "y" if fill == "x" else "x"
    N = n + 2 * h
    nu = n * (n + 1)  # own uc size per face; vc offset = 6*nu

    def uc_flat(g, j, i_face):
        return (g * n + j) * (n + 1) + i_face

    def vc_flat(g, j_face, i):
        return 6 * nu + (g * (n + 1) + j_face) * n + i

    def resolve(f, c1, c2):
        """Map adjacent cell pair (possibly out of face) to the stored
        face value: returns (flat, sign_x, sign_y) where sign_x/sign_y
        are the coefficients for an x-normal / y-normal query slot."""
        from .topology import _edge_map_affine, link, EDGE_W, EDGE_E, \
            EDGE_S, EDGE_N

        def extract(g, cells, M):
            """Return the stored-value triple if the pair is a stored
            face of face g (boundary faces included), else None.

            value_f = M @ (u, v)_g (M maps neighbor components to
            ours); only the mapped face's normal component is stored,
            so the coefficient is the corresponding M entry.
            """
            (j1, i1), (j2, i2) = cells[0], cells[1]
            if j1 == j2 and abs(i1 - i2) == 1:
                if 0 <= j1 < n and 0 <= max(i1, i2) <= n:
                    return (
                        uc_flat(g, int(j1), int(max(i1, i2))),
                        M[0, 0],
                        M[1, 0],
                    )
            if i1 == i2 and abs(j1 - j2) == 1:
                if 0 <= i1 < n and 0 <= max(j1, j2) <= n:
                    return (
                        vc_flat(g, int(max(j1, j2)), int(i1)),
                        M[0, 1],
                        M[1, 1],
                    )
            return None

        M = np.eye(2, dtype=int)
        g = f
        cells = [np.array(c1), np.array(c2)]
        for _ in range(3):
            got = extract(g, cells, M)
            if got is not None:
                return got
            out_j = [not (0 <= c[0] < n) for c in cells]
            out_i = [not (0 <= c[1] < n) for c in cells]
            # a chart change is only valid along a coordinate that is
            # out of range for BOTH cells; when both coordinates qualify
            # (genuine corner), use the fill preference
            j_both = out_j[0] and out_j[1]
            i_both = out_i[0] and out_i[1]
            if j_both and i_both:
                use_y = first == "y"
            elif j_both:
                use_y = True
            elif i_both:
                use_y = False
            else:
                raise RuntimeError("straddling pair cannot be resolved")
            ref = cells[0] if (out_j[0] if use_y else out_i[0]) else cells[1]
            if use_y:
                e = EDGE_S if ref[0] < 0 else EDGE_N
            else:
                e = EDGE_W if ref[1] < 0 else EDGE_E
            l = link(g, e)
            A, b = _edge_map_affine(l, n)
            cells = [A @ c + b for c in cells]
            M = _rot_matrix(l.rot) @ M
            g = l.nbr_face
        raise RuntimeError(f"cgrid resolve failed: {cells}")

    def build(kind):
        if kind == "uc":
            shp = (6, N, N + 1)
        else:
            shp = (6, N + 1, N)
        flat = np.zeros(shp, dtype=np.int64)
        sign = np.zeros(shp, dtype=np.float64)
        for f in range(6):
            for a in range(shp[1]):
                for b_ in range(shp[2]):
                    if kind == "uc":
                        # x-face at padded (row a, face col b_): cells
                        # (a-h, b_-h-1) and (a-h, b_-h)
                        j = a - h
                        c1 = (j, b_ - h - 1)
                        c2 = (j, b_ - h)
                        own = 0 <= j < n and h <= b_ <= h + n
                        if own:
                            flat[f, a, b_] = uc_flat(f, j, b_ - h)
                            sign[f, a, b_] = 1.0
                            continue
                    else:
                        i = b_ - h
                        c1 = (a - h - 1, i)
                        c2 = (a - h, i)
                        own = 0 <= i < n and h <= a <= h + n
                        if own:
                            flat[f, a, b_] = vc_flat(f, a - h, i)
                            sign[f, a, b_] = 1.0
                            continue
                    # skip slots whose cells cannot be resolved (beyond
                    # the diagonal reach of two charts)
                    try:
                        fl, sx, sy = resolve(f, c1, c2)
                    except (RuntimeError, ValueError, KeyError):
                        continue
                    s = sx if kind == "uc" else sy
                    if s == 0:
                        continue
                    flat[f, a, b_] = fl
                    sign[f, a, b_] = float(s)
        return flat, sign

    return build("uc"), build("vc")


def _staggered_affine_plan(tables, h, rows_a, cols_a, rows_b, cols_b,
                           n):
    """Compile a staggered pair's padded gather tables into per-face,
    per-halo-block affine op trees (ops.affine_gather).

    Pool layout (as built by _dgrid_tables/_cgrid_tables): segment 0 =
    array a, per-face [rows_a, cols_a] interiors; segment 1 = array b
    [rows_b, cols_b], offset 6*rows_a*cols_a."""
    from ..ops import affine_gather as ag

    sa = rows_a * cols_a

    def decode(flat):
        flat = np.asarray(flat, np.int64)
        in_a = flat < 6 * sa
        g_a = flat // sa
        r_a = (flat % sa) // cols_a
        c_a = flat % cols_a
        fb = flat - 6 * sa
        sb = rows_b * cols_b
        g_b = fb // sb
        r_b = (fb % sb) // cols_b
        c_b = fb % cols_b
        seg = np.where(in_a, 0, 1)
        return (
            seg,
            np.where(in_a, g_a, g_b),
            np.where(in_a, r_a, r_b),
            np.where(in_a, c_a, c_b),
        )

    def blocks(rows, cols, pr, pc):
        # 8 halo blocks of a padded [pr, pc] array with interior
        # [h:h+rows, h:h+cols]
        return {
            "S": (slice(0, h), slice(h, h + cols)),
            "N": (slice(h + rows, pr), slice(h, h + cols)),
            "W": (slice(h, h + rows), slice(0, h)),
            "E": (slice(h, h + rows), slice(h + cols, pc)),
            "SW": (slice(0, h), slice(0, h)),
            "SE": (slice(0, h), slice(h + cols, pc)),
            "NW": (slice(h + rows, pr), slice(0, h)),
            "NE": (slice(h + rows, pr), slice(h + cols, pc)),
        }

    def compile_side(flat, sign, rows, cols):
        flat = np.asarray(flat)
        sign = np.asarray(sign)
        pr, pc = flat.shape[1], flat.shape[2]
        seg, face, r, c = decode(flat)
        plan = {}
        for name, (rs, cs) in blocks(rows, cols, pr, pc).items():
            plan[name] = tuple(
                ag.compile_block(
                    seg[f, rs, cs], face[f, rs, cs], r[f, rs, cs],
                    c[f, rs, cs], sign[f, rs, cs],
                    widths=(cols_a, cols_b),
                )
                for f in range(6)
            )
        return plan

    (a_flat, a_sign), (b_flat, b_sign) = tables
    return (
        compile_side(a_flat, a_sign, rows_a, cols_a),
        compile_side(b_flat, b_sign, rows_b, cols_b),
    )


def _staggered_gather_exchange(a, b, tables, h, rows_a, cols_a,
                               rows_b, cols_b, dtype):
    """Strip-form flat-gather staggered exchange (pre-affine path for
    faces above AFFINE_MAX_N)."""
    asrc = jnp.moveaxis(a, 0, -3)
    asrc_flat = asrc.reshape(asrc.shape[:-3] + (-1,))
    bsrc = jnp.moveaxis(b, 0, -3)
    bsrc_flat = bsrc.reshape(bsrc.shape[:-3] + (-1,))
    pool = jnp.concatenate([asrc_flat, bsrc_flat], axis=-1)

    def build(src, flat, sign, rows, cols):
        flat = np.asarray(flat)
        sign = np.asarray(sign)
        r0, r1 = h, h + rows
        c0, c1 = h, h + cols

        def take(tf, ts):
            return jnp.take(
                pool, jnp.asarray(tf.astype(np.int32)), axis=-1
            ) * jnp.asarray(ts, dtype)

        s = take(flat[:, :r0, :], sign[:, :r0, :])
        nn_ = take(flat[:, r1:, :], sign[:, r1:, :])
        w = take(flat[:, r0:r1, :c0], sign[:, r0:r1, :c0])
        e = take(flat[:, r0:r1, c1:], sign[:, r0:r1, c1:])
        mid = jnp.concatenate([w, src, e], axis=-1)
        return jnp.concatenate([s, mid, nn_], axis=-2)

    (a_flat, a_sign), (b_flat, b_sign) = tables
    ao = build(asrc, a_flat, a_sign, rows_a, cols_a)
    bo = build(bsrc, b_flat, b_sign, rows_b, cols_b)
    return jnp.moveaxis(ao, -3, 0), jnp.moveaxis(bo, -3, 0)


def _staggered_strip_exchange(a, b, tables, h, rows_a, cols_a, rows_b,
                              cols_b, dtype, plan=None):
    """Shared implementation for C/D-grid pair exchanges: the halo ring
    of each padded array is assembled from the gather tables COMPILED
    to slice/flip/transpose copies (ops.affine_gather; bit-identical to
    the flat gather, memcpy speed) for faces up to AFFINE_MAX_N, and
    as strip gathers above."""
    from ..ops import affine_gather as ag

    if max(cols_a, cols_b) - 1 > AFFINE_MAX_N:
        return _staggered_gather_exchange(
            a, b, tables, h, rows_a, cols_a, rows_b, cols_b, dtype
        )
    if plan is None:
        plan = _staggered_affine_plan(
            tables, h, rows_a, cols_a, rows_b, cols_b, a.shape[-1]
        )
    plan_a, plan_b = plan
    srcs = ([a[g] for g in range(6)], [b[g] for g in range(6)])
    lead = a.shape[1:-2]

    def build(src_faces, plan_side):
        outs = []
        for g in range(6):
            def blk(name):
                return ag.apply_block(srcs, plan_side[name][g], dtype,
                                      lead)

            mid = jnp.concatenate(
                [blk("W"), src_faces[g], blk("E")], axis=-1
            )
            bot = jnp.concatenate(
                [blk("SW"), blk("S"), blk("SE")], axis=-1
            )
            top = jnp.concatenate(
                [blk("NW"), blk("N"), blk("NE")], axis=-1
            )
            outs.append(jnp.concatenate([bot, mid, top], axis=-2))
        return jnp.stack(outs, axis=0)

    return build(srcs[0], plan_a), build(srcs[1], plan_b)


@lru_cache(maxsize=None)
def _cgrid_boundary_canon_tables(n: int):
    """Canonicalization tables for the two stored copies of shared
    boundary C-faces.

    Each face stores its own value for every one of its boundary faces
    (uc columns 0 and n, vc rows 0 and n), so every physical
    tile-boundary face has TWO stored copies.  When the two owners
    compute different values (the reconstructions see different halo
    inputs at corner-adjacent cells), shared-face mass fluxes no longer
    cancel and global conservation breaks for non-symmetric flows.
    These tables let the higher-indexed face adopt the lower-indexed
    face's copy (sign-rotated into its own frame): for every boundary
    slot of every face, (neighbor_pool_index, coefficient,
    replace_mask).  The FMS-equivalent convention is mpp's domain
    symmetry on staggered fields.
    """
    from .topology import (
        _edge_map_affine,
        link,
        EDGE_W,
        EDGE_E,
        EDGE_S,
        EDGE_N,
    )

    nu = n * (n + 1)

    def uc_flat(g, j, i_face):
        return (g * n + j) * (n + 1) + i_face

    def vc_flat(g, j_face, i):
        return 6 * nu + (g * (n + 1) + j_face) * n + i

    def neighbor_copy(f, edge, cells):
        """(pool_flat, coef) of the neighbor's stored copy for the
        boundary face between `cells` = ((j1,i1),(j2,i2)) of face f."""
        l = link(f, edge)
        A, b = _edge_map_affine(l, n)
        M = _rot_matrix(l.rot)
        g = l.nbr_face
        (j1, i1), (j2, i2) = [A @ np.array(c) + b for c in cells]
        if j1 == j2 and abs(i1 - i2) == 1:
            return uc_flat(g, int(j1), int(max(i1, i2))), M[0, 0], M[1, 0]
        if i1 == i2 and abs(j1 - j2) == 1:
            return vc_flat(g, int(max(j1, j2)), int(i1)), M[0, 1], M[1, 1]
        raise RuntimeError("boundary pair did not map to a stored face")

    # output tables over the stored arrays' own shapes
    uc_idx = np.zeros((6, n, n + 1), np.int64)
    uc_coef = np.zeros((6, n, n + 1))
    uc_rep = np.zeros((6, n, n + 1), bool)
    vc_idx = np.zeros((6, n + 1, n), np.int64)
    vc_coef = np.zeros((6, n + 1, n))
    vc_rep = np.zeros((6, n + 1, n), bool)
    for f in range(6):
        for edge, col in ((EDGE_W, 0), (EDGE_E, n)):
            l = link(f, edge)
            if l.nbr_face >= f:
                continue
            for j in range(n):
                cells = ((j, col - 1), (j, col))
                fl, cx, _ = neighbor_copy(f, edge, cells)
                uc_idx[f, j, col] = fl
                uc_coef[f, j, col] = cx
                uc_rep[f, j, col] = True
        for edge, row in ((EDGE_S, 0), (EDGE_N, n)):
            l = link(f, edge)
            if l.nbr_face >= f:
                continue
            for i in range(n):
                cells = ((row - 1, i), (row, i))
                fl, _, cy = neighbor_copy(f, edge, cells)
                vc_idx[f, row, i] = fl
                vc_coef[f, row, i] = cy
                vc_rep[f, row, i] = True
    return (
        uc_idx.astype(np.int32), uc_coef, uc_rep,
        vc_idx.astype(np.int32), vc_coef, vc_rep,
    )


@lru_cache(maxsize=None)
def _dgrid_boundary_pair_tables(n: int):
    """For every boundary D-edge of every face, the (pool_flat, sign)
    of the OTHER face's stored copy of the same physical edge.

    The D-grid state [6, n+1, n]/[6, n, n+1] stores each shared
    boundary edge TWICE (once per adjacent face); the two copies are
    updated independently by each face's stencils and drift apart at
    the inter-face coordinate kink.  These tables support averaging
    the copies (mpp domain-symmetry role).  Cube-corner-touching edges
    are included; entries with pair_mask False have no partner (none,
    for the closed cube).
    """
    from .geometry import gnomonic_grid

    base = gnomonic_grid(n)  # [6, n+1, n+1, 3]
    nu = (n + 1) * n

    table: dict = {}

    def key_of(A, B):
        ka, kb = tuple(_quantize(A)), tuple(_quantize(B))
        return ((ka, kb) if ka <= kb else (kb, ka)), ka

    def store(kind, g, a, b, A, B):
        key, ka = key_of(A, B)
        flat = (
            (g * (n + 1) + a) * n + b
            if kind == "u"
            else 6 * nu + (g * n + a) * (n + 1) + b
        )
        table.setdefault(key, []).append((flat, ka))

    for g in range(6):
        for J in (0, n):
            for i in range(n):
                store("u", g, J, i, base[g, J, i], base[g, J, i + 1])
        for j in range(n):
            for I in (0, n):
                store("v", g, j, I, base[g, j, I], base[g, j + 1, I])

    u_idx = np.zeros((6, n + 1, n), np.int64)
    u_sign = np.zeros((6, n + 1, n))
    u_mask = np.zeros((6, n + 1, n), bool)
    v_idx = np.zeros((6, n, n + 1), np.int64)
    v_sign = np.zeros((6, n, n + 1))
    v_mask = np.zeros((6, n, n + 1), bool)

    def fill(kind, g, a, b, A, B):
        key, ka = key_of(A, B)
        entries = table.get(key, [])
        flat_self = (
            (g * (n + 1) + a) * n + b
            if kind == "u"
            else 6 * nu + (g * n + a) * (n + 1) + b
        )
        others = [e for e in entries if e[0] != flat_self]
        if not others:
            return
        flat, stored_from = others[0]
        sgn = 1.0 if stored_from == ka else -1.0
        if kind == "u":
            u_idx[g, a, b] = flat
            u_sign[g, a, b] = sgn
            u_mask[g, a, b] = True
        else:
            v_idx[g, a, b] = flat
            v_sign[g, a, b] = sgn
            v_mask[g, a, b] = True

    for g in range(6):
        for J in (0, n):
            for i in range(n):
                fill("u", g, J, i, base[g, J, i], base[g, J, i + 1])
        for j in range(n):
            for I in (0, n):
                fill("v", g, j, I, base[g, j, I], base[g, j + 1, I])
    return (
        u_idx.astype(np.int32), u_sign, u_mask,
        v_idx.astype(np.int32), v_sign, v_mask,
    )


def average_dgrid_boundary(u, v):
    """Replace both stored copies of every shared boundary D-edge with
    their (sign-consistent) average.  u: [6, ..., n+1, n],
    v: [6, ..., n, n+1].  Boundary strips are affine-compiled copies
    (ops.affine_gather); interior is untouched."""
    if _SPMD_TILING is not None:
        from ..parallel import tiling as _tl

        return _tl.average_dgrid_boundary_tiled(u, v, _SPMD_TILING)
    if _SPMD_AXIS is not None:
        from ..parallel import halo_spmd as _hs

        return _hs.average_dgrid_boundary_local(u, v, _SPMD_AXIS)
    n = u.shape[-1]
    if n > AFFINE_MAX_N:
        return _average_dgrid_boundary_gather(u, v)
    plan_u, plan_v = _avg_affine_plans(n)
    srcs = ([u[g] for g in range(6)], [v[g] for g in range(6)])

    def combine(own, partner, mask):
        return jnp.where(mask, 0.5 * (own + partner), own)

    uo = _apply_boundary_strips(u, srcs, plan_u, combine)
    vo = _apply_boundary_strips(v, srcs, plan_v, combine)
    return uo, vo


def _pool_strip_partner(u, v, idx, coef, rows_a, cols_a, rows_b,
                        cols_b):
    """Gather partner values for a boundary STRIP without building the
    full flat pool (a full-field pool+take, plus the moveaxis that lines
    up the take axis, moves the whole field for a strip's worth of
    values).

    idx/coef: numpy strip tables of shape [6, R, C] (flat pool indices
    into [u; v]); u [6, *lead, rows_a, cols_a].  Returns the strip of
    partner*coef with shape [6, *lead, R, C] via advanced-index
    gathers batched over the lead dims.
    """
    decode = _pool_decode2(rows_a, cols_a, rows_b, cols_b)
    seg, f, r, c = decode(np.asarray(idx))
    lead = u.ndim - 3

    def take(arr, rr, cc):
        # advanced indices (f, rr, cc) with the lead slice between ->
        # result [6, R, C, *lead]; strips are tiny so the reorder is
        # cheap
        res = arr[
            (jnp.asarray(f), Ellipsis, jnp.asarray(rr),
             jnp.asarray(cc))
        ]
        # advanced dims land first: [6, R, C, *lead] -> [6, *lead, R, C]
        return (
            jnp.moveaxis(res, (1, 2), (-2, -1)) if lead else res
        )

    # clamp out-of-segment rows/cols so both gathers are valid, then
    # select by segment
    ru = np.where(seg == 0, r, 0)
    cu = np.where(seg == 0, c, 0)
    rv = np.where(seg == 1, r, 0)
    cv = np.where(seg == 1, c, 0)
    pu = take(u, ru, cu)
    pv = take(v, rv, cv)
    segb = jnp.asarray((seg == 0))
    if lead:
        segb = segb.reshape(
            (6,) + (1,) * lead + seg.shape[1:]
        )
        coefb = jnp.asarray(coef).reshape(
            (6,) + (1,) * lead + seg.shape[1:]
        )
    else:
        coefb = jnp.asarray(coef)
    return jnp.where(segb, pu, pv) * coefb.astype(u.dtype)


def _average_dgrid_boundary_gather(u, v):
    """Strip-form shared-edge averaging (replacements live only on u's
    first/last row and v's first/last column -- verified against the
    tables)."""
    n = u.shape[-1]
    (u_idx, u_sign, u_mask, v_idx, v_sign, v_mask) = (
        _dgrid_boundary_pair_tables(n)
    )
    u_idx, u_sign, u_mask, v_idx, v_sign, v_mask = (
        np.asarray(a)
        for a in (u_idx, u_sign, u_mask, v_idx, v_sign, v_mask)
    )
    ra, ca, rb, cb = n + 1, n, n, n + 1
    lead = u.ndim - 3

    def bcast(m):
        return jnp.asarray(m).reshape(
            m.shape[:1] + (1,) * lead + m.shape[1:]
        )

    def strip_avg(own, idx, sign, mask):
        partner = _pool_strip_partner(
            u, v, idx, sign, ra, ca, rb, cb
        )
        return jnp.where(
            bcast(mask), 0.5 * (own + partner), own
        )

    uo = jnp.concatenate(
        [
            strip_avg(u[..., :1, :], u_idx[:, :1, :],
                      u_sign[:, :1, :], u_mask[:, :1, :]),
            u[..., 1:-1, :],
            strip_avg(u[..., -1:, :], u_idx[:, -1:, :],
                      u_sign[:, -1:, :], u_mask[:, -1:, :]),
        ],
        axis=-2,
    )
    vo = jnp.concatenate(
        [
            strip_avg(v[..., :, :1], v_idx[:, :, :1],
                      v_sign[:, :, :1], v_mask[:, :, :1]),
            v[..., :, 1:-1],
            strip_avg(v[..., :, -1:], v_idx[:, :, -1:],
                      v_sign[:, :, -1:], v_mask[:, :, -1:]),
        ],
        axis=-1,
    )
    return uo, vo


def canonicalize_cgrid_boundary(uc, vc):
    """Make the two stored copies of every shared boundary C-face equal:
    the higher-indexed face adopts the lower-indexed face's value
    (rotated into its frame).  Restores exact shared-face flux
    cancellation (global mass conservation to roundoff) for arbitrary
    wind fields.  uc: [6, ..., n, n+1]; vc: [6, ..., n+1, n].
    Boundary strips are affine-compiled copies (ops.affine_gather)."""
    if _SPMD_TILING is not None:
        from ..parallel import tiling as _tl

        return _tl.canonicalize_cgrid_boundary_tiled(uc, vc, _SPMD_TILING)
    if _SPMD_AXIS is not None:
        from ..parallel import halo_spmd as _hs

        return _hs.canonicalize_cgrid_boundary_local(uc, vc, _SPMD_AXIS)
    n = uc.shape[-2]
    if n > AFFINE_MAX_N:
        return _canonicalize_cgrid_boundary_gather(uc, vc)
    plan_u, plan_v = _canon_affine_plans(n)
    srcs = ([uc[g] for g in range(6)], [vc[g] for g in range(6)])

    def combine(own, partner, mask):
        return jnp.where(mask, partner, own)

    uo = _apply_boundary_strips(uc, srcs, plan_u, combine)
    vo = _apply_boundary_strips(vc, srcs, plan_v, combine)
    return uo, vo


def _canonicalize_cgrid_boundary_gather(uc, vc):
    """Strip-form: replacements live ONLY on the first/last column of
    uc and first/last row of vc (verified against the tables), so the
    gathers are strip-sized and the interior passes through by
    concatenation.  A gather over the FULL field would have a full-field
    scatter-add as its autodiff transpose; this form has strip-sized
    adjoints."""
    n = uc.shape[-2]
    (uc_idx, uc_coef, uc_rep, vc_idx, vc_coef, vc_rep) = (
        _cgrid_boundary_canon_tables(n)
    )
    uc_idx, uc_coef, uc_rep, vc_idx, vc_coef, vc_rep = (
        np.asarray(a)
        for a in (uc_idx, uc_coef, uc_rep, vc_idx, vc_coef, vc_rep)
    )
    ra, ca, rb, cb = n, n + 1, n + 1, n
    lead = uc.ndim - 3

    def bcast(m):
        return jnp.asarray(m).reshape(
            m.shape[:1] + (1,) * lead + m.shape[1:]
        )

    def strip_canon(own, idx, coef, rep):
        repl = _pool_strip_partner(uc, vc, idx, coef, ra, ca, rb, cb)
        return jnp.where(bcast(rep), repl, own)

    uo = jnp.concatenate(
        [
            strip_canon(uc[..., :, :1], uc_idx[:, :, :1],
                        uc_coef[:, :, :1], uc_rep[:, :, :1]),
            uc[..., :, 1:-1],
            strip_canon(uc[..., :, -1:], uc_idx[:, :, -1:],
                        uc_coef[:, :, -1:], uc_rep[:, :, -1:]),
        ],
        axis=-1,
    )
    vo = jnp.concatenate(
        [
            strip_canon(vc[..., :1, :], vc_idx[:, :1, :],
                        vc_coef[:, :1, :], vc_rep[:, :1, :]),
            vc[..., 1:-1, :],
            strip_canon(vc[..., -1:, :], vc_idx[:, -1:, :],
                        vc_coef[:, -1:, :], vc_rep[:, -1:, :]),
        ],
        axis=-2,
    )
    return uo, vo


def halo_exchange_cgrid(uc, vc, h: int, fill: str = "y"):
    """Halo-exchange C-grid (face-normal) components with corner fill.

    uc: [6, ..., n, n+1] x-component at x-faces; vc: [6, ..., n+1, n].
    Returns padded (uc [6,...,N,N+1], vc [6,...,N+1,N]), N = n+2h, with
    halo AND cube-corner slots holding the neighbors' stored values
    rotated into this face's frame (see _cgrid_tables).
    """
    if _SPMD_TILING is not None:
        from ..parallel import tiling as _tl

        return _tl.halo_exchange_cgrid_tiled(uc, vc, _SPMD_TILING, fill)
    if _SPMD_AXIS is not None:
        from ..parallel import halo_spmd as _hs

        return _hs.halo_exchange_cgrid_local(uc, vc, h, fill, _SPMD_AXIS)
    # the linear primitive (halo_transpose) runs the strip exchange
    # forward and a gather-based transpose backward, so vjp-built
    # operators (div_damp) avoid autodiff scatter-adds
    from .halo_transpose import cgrid_exchange_linear

    return cgrid_exchange_linear(uc, vc, h, fill)


def halo_exchange_dgrid(u, v, h: int):
    """Halo-exchange D-grid staggered winds.

    u: [6, ..., n+1, n] x-edge tangential component
    v: [6, ..., n, n+1] y-edge tangential component
    Returns padded (u [6,...,n+2h+1,n+2h], v [6,...,n+2h,n+2h+1]); the halo
    holds the neighbor's u or v value on the same physical edge with the
    correct sign.  Positions with no well-defined source (cube corners)
    are zero.
    """
    if _SPMD_TILING is not None:
        from ..parallel import tiling as _tl

        return _tl.halo_exchange_dgrid_tiled(u, v, _SPMD_TILING)
    if _SPMD_AXIS is not None:
        from ..parallel import halo_spmd as _hs

        return _hs.halo_exchange_dgrid_local(u, v, h, _SPMD_AXIS)
    # gather-based transpose (see halo_transpose.py): the vjp of a
    # table gather is otherwise a scatter-add, ~20 ms/damper at C192
    from .halo_transpose import dgrid_exchange_linear

    return dgrid_exchange_linear(u, v, h)


@lru_cache(maxsize=None)
def _dgrid_affine_plans(n: int, h: int):
    return _staggered_affine_plan(
        _dgrid_tables(n, h), h, n + 1, n, n, n + 1, n
    )


@lru_cache(maxsize=None)
def _cgrid_affine_plans(n: int, h: int, fill: str):
    return _staggered_affine_plan(
        _cgrid_tables(n, h, fill), h, n, n + 1, n + 1, n, n
    )

def _pool_decode2(rows_a, cols_a, rows_b, cols_b):
    """Decode flat indices of a 2-segment per-face pool (segment 0 =
    [6, rows_a, cols_a], segment 1 offset 6*rows_a*cols_a)."""
    sa = rows_a * cols_a
    sb = rows_b * cols_b

    def decode(flat):
        flat = np.asarray(flat, np.int64)
        in_a = flat < 6 * sa
        fb = flat - 6 * sa
        return (
            np.where(in_a, 0, 1),
            np.where(in_a, flat // sa, fb // sb),
            np.where(in_a, (flat % sa) // cols_a, (fb % sb) // cols_b),
            np.where(in_a, flat % cols_a, fb % cols_b),
        )

    return decode


def _compile_boundary_strips(idx, sign, mask, rows, cols, decode,
                             widths):
    """Compile the 4 boundary strips (first/last row and col) of a
    full-array replacement table into affine op trees; interior slots
    are untouched pass-through.  Returns {(axis, which): (tree, mask,
    rs, cs)} entries for strips that have any active slot."""
    from ..ops import affine_gather as ag

    idx = np.asarray(idx)
    sign = np.asarray(sign, float)
    mask = np.asarray(mask, bool)
    seg, face, r, c = decode(idx)
    sig = np.where(mask, sign, 0.0)
    out = {}
    # disjoint strips: corners belong to the row strips only, so no
    # slot is applied twice (the table semantics apply each slot once)
    strips = {
        (-2, 0): (slice(0, 1), slice(None)),
        (-2, 1): (slice(rows - 1, rows), slice(None)),
        (-1, 0): (slice(1, rows - 1), slice(0, 1)),
        (-1, 1): (slice(1, rows - 1), slice(cols - 1, cols)),
    }
    for key, (rs, cs) in strips.items():
        if not mask[:, rs, cs].any():
            continue
        trees = tuple(
            ag.compile_block(
                seg[f, rs, cs], face[f, rs, cs], r[f, rs, cs],
                c[f, rs, cs], sig[f, rs, cs], widths=widths,
            )
            for f in range(6)
        )
        out[key] = (trees, mask[:, rs, cs], rs, cs)
    return out


def _apply_boundary_strips(arr, srcs, strip_plan, combine):
    """Overwrite the compiled boundary strips of arr [6, lead..., R, C]
    with combine(own_strip, partner_strip, mask).  Strips are disjoint
    (corners live in the row strips), so application order is
    immaterial."""
    from ..ops import affine_gather as ag

    lead = arr.shape[1:-2]
    dtype = arr.dtype
    R, C = arr.shape[-2], arr.shape[-1]
    for (axis, which), (trees, mask, rs, cs) in strip_plan.items():
        new_faces = []
        for g in range(6):
            own = arr[g][..., rs, cs]
            partner = ag.apply_block(srcs, trees[g], dtype, lead)
            new_faces.append(combine(own, partner, jnp.asarray(mask[g])))
        new_strip = jnp.stack(new_faces, axis=0)
        if axis == -2:
            lo = 0 if which == 0 else R - 1
            arr = jnp.concatenate(
                [arr[..., :lo, :], new_strip, arr[..., lo + 1 :, :]],
                axis=-2,
            )
        else:
            lo = 0 if which == 0 else C - 1
            # col strips span interior rows [1, R-1); keep the corner
            # rows of the existing column
            col = jnp.concatenate(
                [
                    arr[..., 0:1, lo : lo + 1],
                    new_strip,
                    arr[..., R - 1 : R, lo : lo + 1],
                ],
                axis=-2,
            )
            arr = jnp.concatenate(
                [arr[..., :, :lo], col, arr[..., :, lo + 1 :]],
                axis=-1,
            )
    return arr


@lru_cache(maxsize=None)
def _avg_affine_plans(n: int):
    (u_idx, u_sign, u_mask, v_idx, v_sign, v_mask) = (
        _dgrid_boundary_pair_tables(n)
    )
    decode = _pool_decode2(n + 1, n, n, n + 1)
    return (
        _compile_boundary_strips(u_idx, u_sign, u_mask, n + 1, n,
                                 decode, (n, n + 1)),
        _compile_boundary_strips(v_idx, v_sign, v_mask, n, n + 1,
                                 decode, (n, n + 1)),
    )


@lru_cache(maxsize=None)
def _canon_affine_plans(n: int):
    (uc_idx, uc_coef, uc_rep, vc_idx, vc_coef, vc_rep) = (
        _cgrid_boundary_canon_tables(n)
    )
    decode = _pool_decode2(n, n + 1, n + 1, n)
    return (
        _compile_boundary_strips(uc_idx, uc_coef, uc_rep, n, n + 1,
                                 decode, (n + 1, n)),
        _compile_boundary_strips(vc_idx, vc_coef, vc_rep, n + 1, n,
                                 decode, (n + 1, n)),
    )
