"""Compile static gather tables into slice/flip/transpose copies.

The halo exchanges in this framework are defined by static gather
tables (grid/topology.py): per output slot, a (source face, j, i[,
sign]).  Executing them as flat ``jnp.take`` gathers is correct, but
an arbitrary-index gather reads element at a time where a copy of a
contiguous strip streams.  The FV3 cube topology only ever maps CONTIGUOUS
strips with one of the 8 square symmetries, so every table block is
piecewise AFFINE: ``j = j0 + a*dja + b*djb, i = i0 + a*dia + b*dib``
with strides in {-1, 0, 1} and a constant sign.

This module detects that structure and compiles each block into
``lax.slice`` + flip + transpose copies, which XLA fuses into
roofline-speed memcpys.  Detection is self-verifying: a block is
affine iff the affine formula reproduces the table EXACTLY; anything
else (clamped fill-none corners, zero-sign slots, mixed sources) is
recursively bisected until affine/zero/singleton leaves remain, so the
compiled plan is bit-identical to the gather by construction -- the
gather tables stay the single source of truth.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class _Affine:
    """out[a, b] = sign * src[seg][face][j0 + a*dja + b*djb,
    i0 + a*dia + b*dib]"""

    seg: int
    face: int
    j0: int
    i0: int
    dja: int
    djb: int
    dia: int
    dib: int
    sign: float
    bh: int
    bw: int


@dataclasses.dataclass(frozen=True)
class _Zero:
    bh: int
    bw: int


@dataclasses.dataclass(frozen=True)
class _Gather:
    """Fallback: per-slot gather from one (seg, face) flat array."""

    seg: int
    face: int
    tbl: np.ndarray  # [bh, bw] flat j*W+i
    sign: np.ndarray  # [bh, bw]


@dataclasses.dataclass(frozen=True)
class _Split:
    axis: int  # 0 rows, 1 cols
    at: int
    lo: object
    hi: object


def _try_affine(seg, face, j, i, sign) -> Optional[_Affine]:
    bh, bw = j.shape
    if not (seg == seg.flat[0]).all() or not (face == face.flat[0]).all():
        return None
    s0 = sign.flat[0]
    if s0 == 0 or not (sign == s0).all():
        return None
    j0, i0 = int(j[0, 0]), int(i[0, 0])
    dja = int(j[1, 0] - j0) if bh > 1 else 0
    djb = int(j[0, 1] - j0) if bw > 1 else 0
    dia = int(i[1, 0] - i0) if bh > 1 else 0
    dib = int(i[0, 1] - i0) if bw > 1 else 0
    if any(abs(d) > 1 for d in (dja, djb, dia, dib)):
        return None
    a = np.arange(bh)[:, None]
    b = np.arange(bw)[None, :]
    if not ((j0 + a * dja + b * djb == j).all()
            and (i0 + a * dia + b * dib == i).all()):
        return None
    # only pure / transposed orientations are extractable with
    # slice+flip+transpose
    if not ((djb == 0 and dia == 0) or (dja == 0 and dib == 0)):
        return None
    return _Affine(int(seg.flat[0]), int(face.flat[0]), j0, i0,
                   dja, djb, dia, dib, float(s0), bh, bw)


def compile_block(seg, face, j, i, sign, widths, max_leaves=64):
    """Build the op tree for one receiver block.

    seg/face/j/i/sign: [bh, bw] numpy tables; widths[seg] = source
    array W (for gather-leaf flat indices)."""

    def rec(sl_r, sl_c, depth):
        sj = j[sl_r, sl_c]
        si = i[sl_r, sl_c]
        sg = sign[sl_r, sl_c]
        ss = seg[sl_r, sl_c]
        sf = face[sl_r, sl_c]
        bh, bw = sj.shape
        if (sg == 0).all():
            return _Zero(bh, bw)
        spec = _try_affine(ss, sf, sj, si, sg)
        if spec is not None:
            return spec
        uniform = (ss == ss.flat[0]).all() and (sf == sf.flat[0]).all()
        if uniform and ((bh == 1 and bw == 1) or depth <= 0):
            W = widths[int(ss.flat[0])]
            return _Gather(
                int(ss.flat[0]), int(sf.flat[0]),
                (sj * W + si).astype(np.int64), sg.astype(float),
            )
        if depth <= 0:
            raise RuntimeError(
                "affine compile: mixed-source block at recursion limit"
            )
        if bh >= bw:
            mid = bh // 2
            lo = rec(slice(sl_r.start, sl_r.start + mid), sl_c,
                     depth - 1)
            hi = rec(slice(sl_r.start + mid, sl_r.stop), sl_c,
                     depth - 1)
            return _Split(0, mid, lo, hi)
        mid = bw // 2
        lo = rec(sl_r, slice(sl_c.start, sl_c.start + mid), depth - 1)
        hi = rec(sl_r, slice(sl_c.start + mid, sl_c.stop), depth - 1)
        return _Split(1, mid, lo, hi)

    bh, bw = j.shape
    return rec(slice(0, bh), slice(0, bw), 14)


def _extract_affine(srcs, sp: _Affine, dtype):
    S = srcs[sp.seg][sp.face]  # [lead..., H, W]
    if sp.djb == 0 and sp.dia == 0:
        # rows from a, cols from b
        blk = S
        if sp.dja == 0:
            blk = blk[..., sp.j0 : sp.j0 + 1, :]
        elif sp.dja == 1:
            blk = blk[..., sp.j0 : sp.j0 + sp.bh, :]
        else:
            blk = blk[..., sp.j0 - sp.bh + 1 : sp.j0 + 1, :][
                ..., ::-1, :
            ]
        if sp.dib == 0:
            blk = blk[..., :, sp.i0 : sp.i0 + 1]
        elif sp.dib == 1:
            blk = blk[..., :, sp.i0 : sp.i0 + sp.bw]
        else:
            blk = blk[..., :, sp.i0 - sp.bw + 1 : sp.i0 + 1][
                ..., :, ::-1
            ]
        blk = jnp.broadcast_to(
            blk, blk.shape[:-2] + (sp.bh, sp.bw)
        )
    else:
        # transposed: rows indexed by b (stride djb), cols by a (dia)
        blk = S
        if sp.djb == 0:
            blk = blk[..., sp.j0 : sp.j0 + 1, :]
        elif sp.djb == 1:
            blk = blk[..., sp.j0 : sp.j0 + sp.bw, :]
        else:
            blk = blk[..., sp.j0 - sp.bw + 1 : sp.j0 + 1, :][
                ..., ::-1, :
            ]
        if sp.dia == 0:
            blk = blk[..., :, sp.i0 : sp.i0 + 1]
        elif sp.dia == 1:
            blk = blk[..., :, sp.i0 : sp.i0 + sp.bh]
        else:
            blk = blk[..., :, sp.i0 - sp.bh + 1 : sp.i0 + 1][
                ..., :, ::-1
            ]
        blk = jnp.broadcast_to(
            blk, blk.shape[:-2] + (sp.bw, sp.bh)
        )
        blk = jnp.swapaxes(blk, -1, -2)
    if sp.sign != 1.0:
        blk = blk * jnp.asarray(sp.sign, dtype)
    return blk


def apply_block(srcs, tree, dtype, lead_shape):
    """Materialize one receiver block.

    srcs: per-segment tuples/lists of per-face arrays [lead..., H, W];
    returns [lead..., bh, bw]."""
    if isinstance(tree, _Zero):
        return jnp.zeros(lead_shape + (tree.bh, tree.bw), dtype)
    if isinstance(tree, _Affine):
        return _extract_affine(srcs, tree, dtype)
    if isinstance(tree, _Gather):
        S = srcs[tree.seg][tree.face]
        flat = S.reshape(S.shape[:-2] + (-1,))
        out = jnp.take(flat, jnp.asarray(tree.tbl.ravel()), axis=-1)
        out = out * jnp.asarray(tree.sign.ravel(), dtype)
        return out.reshape(S.shape[:-2] + tree.tbl.shape)
    # _Split
    lo = apply_block(srcs, tree.lo, dtype, lead_shape)
    hi = apply_block(srcs, tree.hi, dtype, lead_shape)
    return jnp.concatenate([lo, hi], axis=-2 + tree.axis)


def count_leaves(tree, kinds=(_Gather,)):
    if isinstance(tree, _Split):
        return count_leaves(tree.lo, kinds) + count_leaves(
            tree.hi, kinds
        )
    return 1 if isinstance(tree, kinds) else 0
