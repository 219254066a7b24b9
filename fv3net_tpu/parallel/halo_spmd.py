"""Explicit ppermute halo exchange over the face-sharded device mesh.

This is the production multi-chip halo path (SURVEY 2.3, 7 Phase 2):
instead of letting the XLA SPMD partitioner turn the single-device
flat gathers (grid/halo.py:65) into all-gathers over the whole cube,
each face shard sends exactly its edge strips to its topological
neighbors as `jax.lax.ppermute` neighbor exchanges over the device
interconnect -- the JAX equivalent of FMS `mpp_update_domains` halo
updates.

Design: all orientation handling happens on the SENDER.  For every
halo block of the padded array (4 edge strips + 4 corner blocks) the
static topology tables (grid/topology.py halo_source_indices[_filled])
say which interior cells of which neighbor face supply it; the sender
gathers those cells pre-rotated into the receiver's index order, one
ppermute ships them, and the receiver concatenates -- no per-receiver
reshuffling.  Where one face sources several receivers for the same
block type (cube corners), the exchange is split into rounds with
unique senders and the rounds summed (non-participating destinations
receive zeros).

The gather tables are numpy compile-time constants; the only runtime
communication is 8 ppermutes of O(h*n) strips per field.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..grid import topology as topo


@dataclasses.dataclass(frozen=True)
class _Round:
    """One ppermute round for a halo block: each sender appears once."""

    perm: Tuple[Tuple[int, int], ...]  # (src_face, dst_face)
    tbl_stack: np.ndarray  # [6, block_cells] local flat gather indices


def _blocks(n: int, h: int):
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
def _exchange_plan(n: int, h: int, fill: str):
    """Rounds for every halo block, from the topology tables."""
    if fill == "none":
        src_face, src_j, src_i, _ = topo.halo_source_indices(n, h)
    else:
        src_face, src_j, src_i, _ = topo.halo_source_indices_filled(
            n, h, fill
        )
    plan: Dict[str, List[_Round]] = {}
    for name, (rows, cols) in _blocks(n, h).items():
        sf = src_face[:, rows, cols]  # [6, bh, bw] per receiver
        sj = src_j[:, rows, cols]
        si = src_i[:, rows, cols]
        bh, bw = sf.shape[1], sf.shape[2]
        # cells whose source is the receiver itself (clipped fill-none
        # corners referencing own edge cells) need no communication;
        # handled as a self-pair in a round.
        per_recv = []
        for f in range(6):
            faces = np.unique(sf[f])
            if len(faces) != 1:
                raise NotImplementedError(
                    f"halo block {name} of face {f} has mixed "
                    f"sources {faces}; split-by-source not needed "
                    "for the FV3 topology"
                )
            g = int(faces[0])
            tbl = (sj[f] * n + si[f]).astype(np.int32).ravel()
            per_recv.append((g, tbl))
        # group receivers into rounds with unique senders
        rounds: List[_Round] = []
        remaining = list(range(6))
        while remaining:
            used, perm, batch = set(), [], {}
            rest = []
            for f in remaining:
                g, tbl = per_recv[f]
                if g in used:
                    rest.append(f)
                    continue
                used.add(g)
                perm.append((g, f))
                batch[g] = tbl
            tbl_stack = np.zeros((6, bh * bw), np.int32)
            for g, tbl in batch.items():
                tbl_stack[g] = tbl
            rounds.append(_Round(tuple(perm), tbl_stack))
            remaining = rest
        plan[name] = rounds
    return plan, (n, h)


def halo_exchange_spmd(field, h: int, mesh: Mesh, fill: str = "none"):
    """Pad a face-sharded scalar [6, ..., n, n] with h halo cells using
    shard_map + ppermute neighbor exchanges.

    Semantically identical to grid.halo.halo_exchange (same topology
    tables); communication is edge strips over the mesh's "face" axis
    instead of SPMD-partitioned global gathers.
    """
    n = field.shape[-1]
    if dict(mesh.shape).get("face") != 6:
        raise ValueError(
            "halo_exchange_spmd needs a mesh with a 6-way 'face' axis"
        )
    plan, _ = _exchange_plan(n, h, fill)
    ndim = field.ndim
    spec = P("face", *([None] * (ndim - 1)))

    def body(x):
        local = x[0]  # [..., n, n]
        lead = local.shape[:-2]
        flat = local.reshape(lead + (n * n,))
        fidx = jax.lax.axis_index("face")

        def fetch(name, bh, bw):
            total = None
            for rnd in plan[name]:
                tbl = jnp.asarray(rnd.tbl_stack)[fidx]
                send = jnp.take(flat, tbl, axis=-1)
                # self-pairs short-circuit (no interconnect hop for clipped
                # own-face corner fills)
                self_pairs = all(s == d for s, d in rnd.perm)
                if self_pairs:
                    recv = send
                else:
                    recv = jax.lax.ppermute(
                        send, "face", list(rnd.perm)
                    )
                total = recv if total is None else total + recv
            return total.reshape(lead + (bh, bw))

        w = fetch("W", n, h)
        e = fetch("E", n, h)
        s = fetch("S", h, n)
        nb = fetch("N", h, n)
        sw = fetch("SW", h, h)
        se = fetch("SE", h, h)
        nw = fetch("NW", h, h)
        ne = fetch("NE", h, h)
        mid = jnp.concatenate([w, local, e], axis=-1)
        bot = jnp.concatenate([sw, s, se], axis=-1)
        top = jnp.concatenate([nw, nb, ne], axis=-1)
        out = jnp.concatenate([bot, mid, top], axis=-2)
        return out[None]

    return jax.shard_map(
        body, mesh=mesh, in_specs=spec, out_specs=spec
    )(field)


# --------------------------------------------------------------------------
# Generalized pool exchanges: run ANY of the full-cube gather-table
# exchanges (D-grid, C-grid, boundary canonicalization/averaging) as
# shard-local gathers + ppermute rounds.  This is what lets the dycore
# code run UNCHANGED inside shard_map over the face axis: the halo
# functions in grid/halo.py dispatch here when spmd_mode is active
# (grid.halo.spmd_mode), so the single-device gather path and the
# multi-chip ppermute path share one numerical definition.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _PoolRound:
    perm: Tuple[Tuple[int, int], ...]
    tbl: np.ndarray  # [6, out_size] SENDER-side local gather indices
    sign: np.ndarray  # [6, out_size] SENDER-side signs (0 = not sent)


@dataclasses.dataclass(frozen=True)
class _PoolPlan:
    out_shape: Tuple[int, ...]
    local_tbl: np.ndarray  # [6, out_size]
    local_sign: np.ndarray
    rounds: Tuple[_PoolRound, ...]


def _decode_pool(flat, size_u, size_v):
    """Global pool index ([6*size_u] u-block then [6*size_v] v-block)
    -> (source face, face-local pool index in [0, size_u+size_v))."""
    flat = np.asarray(flat, np.int64)
    in_u = flat < 6 * size_u
    g = np.where(in_u, flat // size_u, (flat - 6 * size_u) // size_v)
    loc = np.where(
        in_u, flat % size_u, size_u + (flat - 6 * size_u) % size_v
    )
    return g.astype(np.int32), loc.astype(np.int32)


def _build_pool_plan(src_face, src_loc, sign):
    """Build gather+ppermute rounds from per-receiver full tables.

    src_face/src_loc/sign: [6, *out_shape]; each receiver face f's
    output slot takes sign * pool_{src_face}[src_loc].  Entries with
    sign == 0 contribute nothing.
    """
    out_shape = src_face.shape[1:]
    size = int(np.prod(out_shape))
    sf = src_face.reshape(6, size)
    sl = src_loc.reshape(6, size)
    sg = np.asarray(sign, np.float64).reshape(6, size)
    own = sf == np.arange(6)[:, None]
    local_tbl = np.where(own, sl, 0).astype(np.int32)
    local_sign = np.where(own, sg, 0.0)
    pairs = {}
    for f in range(6):
        for gv in np.unique(sf[f]):
            g = int(gv)
            if g == f:
                continue
            mask = (sf[f] == g) & (sg[f] != 0)
            if not mask.any():
                continue
            pairs[(g, f)] = (
                np.where(mask, sl[f], 0).astype(np.int32),
                np.where(mask, sg[f], 0.0),
            )
    rounds = []
    rem = dict(pairs)
    while rem:
        used_s, used_r, batch = set(), set(), {}
        for (gf, ff) in list(rem):
            if gf in used_s or ff in used_r:
                continue
            used_s.add(gf)
            used_r.add(ff)
            batch[(gf, ff)] = rem.pop((gf, ff))
        tbl = np.zeros((6, size), np.int32)
        sg_s = np.zeros((6, size))
        for (gf, ff), (t, s) in batch.items():
            tbl[gf] = t
            sg_s[gf] = s
        rounds.append(_PoolRound(tuple(batch), tbl, sg_s))
    return _PoolPlan(tuple(out_shape), local_tbl, local_sign,
                     tuple(rounds))


def _apply_pool_plan(plan: _PoolPlan, pool, axis: str):
    """pool: [lead..., pool_size] local values; returns
    [lead..., *out_shape]."""
    fidx = jax.lax.axis_index(axis)

    def takeg(tbl, sg):
        t = jnp.asarray(tbl)[fidx]
        s = jnp.asarray(sg, pool.dtype)[fidx]
        return jnp.take(pool, t, axis=-1) * s

    out = takeg(plan.local_tbl, plan.local_sign)
    for rnd in plan.rounds:
        send = takeg(rnd.tbl, rnd.sign)
        recv = jax.lax.ppermute(send, axis, list(rnd.perm))
        out = out + recv
    return out.reshape(pool.shape[:-1] + plan.out_shape)


def _uv_pool(u, v):
    """Local (face-axis-1) staggered pair -> [lead..., size_u+size_v]
    pool plus the lead shape."""
    ul = u[0]
    vl = v[0]
    lead = ul.shape[:-2]
    up = ul.reshape(lead + (-1,))
    vp = vl.reshape(lead + (-1,))
    return jnp.concatenate([up, vp], axis=-1)


@lru_cache(maxsize=None)
def _dgrid_plans(n: int, h: int):
    from ..grid.halo import _dgrid_tables

    (uf, us), (vf, vs) = _dgrid_tables(n, h)
    size_u, size_v = (n + 1) * n, n * (n + 1)
    gu, lu = _decode_pool(uf, size_u, size_v)
    gv, lv = _decode_pool(vf, size_u, size_v)
    return (
        _build_pool_plan(gu, lu, us),
        _build_pool_plan(gv, lv, vs),
    )


def halo_exchange_dgrid_local(u, v, h: int, axis: str = "face"):
    """shard-local D-grid exchange (u [1,...,n+1,n], v [1,...,n,n+1])."""
    n = u.shape[-1]
    pu, pv = _dgrid_plans(n, h)
    pool = _uv_pool(u, v)
    up = _apply_pool_plan(pu, pool, axis)[None]
    vp = _apply_pool_plan(pv, pool, axis)[None]
    return up, vp


@lru_cache(maxsize=None)
def _cgrid_plans(n: int, h: int, fill: str):
    from ..grid.halo import _cgrid_tables

    (uf, us), (vf, vs) = _cgrid_tables(n, h, fill)
    size_u, size_v = n * (n + 1), (n + 1) * n
    gu, lu = _decode_pool(uf, size_u, size_v)
    gv, lv = _decode_pool(vf, size_u, size_v)
    return (
        _build_pool_plan(gu, lu, us),
        _build_pool_plan(gv, lv, vs),
    )


def halo_exchange_cgrid_local(uc, vc, h: int, fill: str = "y",
                              axis: str = "face"):
    n = uc.shape[-2]
    pu, pv = _cgrid_plans(n, h, fill)
    pool = _uv_pool(uc, vc)
    up = _apply_pool_plan(pu, pool, axis)[None]
    vp = _apply_pool_plan(pv, pool, axis)[None]
    return up, vp


@lru_cache(maxsize=None)
def _canon_plans(n: int):
    from ..grid.halo import _cgrid_boundary_canon_tables

    (uc_idx, uc_coef, uc_rep, vc_idx, vc_coef, vc_rep) = (
        _cgrid_boundary_canon_tables(n)
    )
    size_u, size_v = n * (n + 1), (n + 1) * n
    faces = np.arange(6)

    def mk(idx, coef, rep, own_shape, own_offset):
        # slots not replaced read their OWN local value
        own_loc = (
            own_offset
            + np.arange(int(np.prod(own_shape[1:])))
            .reshape(own_shape[1:])[None]
            * np.ones((6,) + own_shape[1:], np.int64)
        ).astype(np.int64)
        g, loc = _decode_pool(idx, size_u, size_v)
        g = np.where(rep, g, faces.reshape(6, 1, 1))
        loc = np.where(rep, loc, own_loc)
        sg = np.where(rep, coef, 1.0)
        return _build_pool_plan(g, loc.astype(np.int32), sg)

    pu = mk(uc_idx, uc_coef, uc_rep, (6, n, n + 1), 0)
    pv = mk(vc_idx, vc_coef, vc_rep, (6, n + 1, n), size_u)
    return pu, pv


def canonicalize_cgrid_boundary_local(uc, vc, axis: str = "face"):
    n = uc.shape[-2]
    pu, pv = _canon_plans(n)
    pool = _uv_pool(uc, vc)
    uo = _apply_pool_plan(pu, pool, axis)[None]
    vo = _apply_pool_plan(pv, pool, axis)[None]
    return uo, vo


@lru_cache(maxsize=None)
def _avg_plans(n: int):
    from ..grid.halo import _dgrid_boundary_pair_tables

    (u_idx, u_sign, u_mask, v_idx, v_sign, v_mask) = (
        _dgrid_boundary_pair_tables(n)
    )
    size_u, size_v = (n + 1) * n, n * (n + 1)
    faces = np.arange(6)

    def mk(idx, sgn, mask, own_shape, own_offset):
        own_loc = (
            own_offset
            + np.arange(int(np.prod(own_shape[1:])))
            .reshape(own_shape[1:])[None]
            * np.ones((6,) + own_shape[1:], np.int64)
        ).astype(np.int64)
        g, loc = _decode_pool(idx, size_u, size_v)
        # averaged slots: 0.5*own + 0.5*sign*partner; others: own
        g_own = faces.reshape(6, 1, 1) * np.ones_like(g)
        # build as TWO stacked contributions by summing plans is
        # awkward; instead encode: own part via local identity plan,
        # partner part via a masked remote plan, combined at runtime.
        partner = _build_pool_plan(
            np.where(mask, g, g_own),
            np.where(mask, loc, own_loc).astype(np.int32),
            np.where(mask, 0.5 * sgn, 0.0),
        )
        own = _build_pool_plan(
            g_own.astype(np.int32),
            own_loc.astype(np.int32),
            np.where(mask, 0.5, 1.0),
        )
        return own, partner

    return (
        mk(u_idx, u_sign, u_mask, (6, n + 1, n), 0),
        mk(v_idx, v_sign, v_mask, (6, n, n + 1), size_u),
    )


def average_dgrid_boundary_local(u, v, axis: str = "face"):
    n = u.shape[-1]
    (u_own, u_part), (v_own, v_part) = _avg_plans(n)
    pool = _uv_pool(u, v)
    uo = (
        _apply_pool_plan(u_own, pool, axis)
        + _apply_pool_plan(u_part, pool, axis)
    )[None]
    vo = (
        _apply_pool_plan(v_own, pool, axis)
        + _apply_pool_plan(v_part, pool, axis)
    )[None]
    return uo, vo


def halo_exchange_local(field, h: int, fill: str = "none",
                        axis: str = "face"):
    """shard-local scalar halo exchange (field [1, ..., n, n]):
    identical semantics to grid.halo.halo_exchange."""
    n = field.shape[-1]
    plan = _scalar_full_plan(n, h, fill)
    local = field[0]
    lead = local.shape[:-2]
    pool = local.reshape(lead + (-1,))
    return _apply_pool_plan(plan, pool, axis)[None]


@lru_cache(maxsize=None)
def _scalar_full_plan(n: int, h: int, fill: str):
    from ..grid import topology as topo

    if fill == "none":
        src_face, src_j, src_i, _ = topo.halo_source_indices(n, h)
    else:
        src_face, src_j, src_i, _ = topo.halo_source_indices_filled(
            n, h, fill
        )
    loc = (src_j.astype(np.int64) * n + src_i).astype(np.int32)
    sign = np.ones_like(loc, np.float64)
    return _build_pool_plan(
        src_face.astype(np.int32), loc, sign
    )
