"""Cubed-sphere block coarsening (vcm/cubedsphere/coarsen.py, JAX-native).

The reference's coarsening engine reduces C3072/C384 output to C48
training resolution with dask-parallel block reductions
(coarsen.py:183-900).  Here they are trivial reshape-reduce XLA ops;
the functions below operate on the trailing (y, x) axes of any array and
keep the reference semantics: weighted averages for cell quantities,
edge-weighted averages for staggered winds, sums for fluxes, medians /
modes for surface categories, and upsampling.
"""

from __future__ import annotations

import numpy as np


def _get_xp(a):
    if isinstance(a, np.ndarray):
        return np
    import jax.numpy as jnp

    return jnp


def _block_view(a, factor):
    """[..., y, x] -> [..., y/f, f, x/f, f]"""
    xp = _get_xp(a)
    *lead, ny, nx = a.shape
    if ny % factor or nx % factor:
        raise ValueError(
            f"cannot coarsen shape {a.shape} by factor {factor}"
        )
    return a.reshape(*lead, ny // factor, factor, nx // factor, factor)


def block_coarsen(a, factor: int, method: str = "mean"):
    """(coarsen.py:795): reduce factor x factor blocks."""
    v = _block_view(a, factor)
    xp = _get_xp(a)
    if method == "mean":
        return v.mean(axis=(-3, -1))
    if method == "sum":
        return v.sum(axis=(-3, -1))
    if method == "min":
        return v.min(axis=(-3, -1))
    if method == "max":
        return v.max(axis=(-3, -1))
    if method == "median":
        return block_median(a, factor)
    raise ValueError(f"unknown method {method}")


def weighted_block_average(a, weights, factor: int):
    """(coarsen.py:183): e.g. area-weighted field coarsening."""
    va = _block_view(a * weights, factor)
    vw = _block_view(np.broadcast_to(weights, a.shape)
                     if isinstance(a, np.ndarray) else weights * (a * 0 + 1),
                     factor)
    return va.sum(axis=(-3, -1)) / vw.sum(axis=(-3, -1))


def edge_weighted_block_average(a, spacing, factor: int, axis: int):
    """(coarsen.py:221): coarsen staggered edge data: length-weighted
    mean along the edge direction, subsample across it.

    axis: -1 to reduce along x (data staggered in y), -2 along y.
    """
    xp = _get_xp(a)
    w = a * spacing
    if axis == -1:
        *lead, ny, nx = a.shape
        wv = w.reshape(*lead, ny, nx // factor, factor)
        sv = spacing.reshape(
            *spacing.shape[:-2], ny, nx // factor, factor
        )
        avg = wv.sum(-1) / sv.sum(-1)
        return avg[..., ::factor, :]
    if axis == -2:
        *lead, ny, nx = a.shape
        wv = w.reshape(*lead, ny // factor, factor, nx)
        sv = spacing.reshape(
            *spacing.shape[:-2], ny // factor, factor, nx
        )
        avg = wv.sum(-2) / sv.sum(-2)
        return avg[..., :, ::factor]
    raise ValueError(axis)


def block_edge_sum(a, factor: int, axis: int):
    """(coarsen.py:591): sum staggered edge data within blocks along the
    edge, subsampling across."""
    if axis == -1:
        *lead, ny, nx = a.shape
        s = a.reshape(*lead, ny, nx // factor, factor).sum(-1)
        return s[..., ::factor, :]
    if axis == -2:
        *lead, ny, nx = a.shape
        s = a.reshape(*lead, ny // factor, factor, nx).sum(-2)
        return s[..., :, ::factor]
    raise ValueError(axis)


def block_median(a, factor: int):
    """(coarsen.py:557)"""
    v = _block_view(a, factor)
    xp = _get_xp(a)
    *lead, nyc, f1, nxc, f2 = v.shape
    flat = v.swapaxes(-3, -2).reshape(*lead, nyc, nxc, f1 * f2)
    return xp.median(flat, axis=-1)


def block_mode(a, factor: int):
    """(coarsen.py:750): most common value per block (for categorical
    surface fields)."""
    v = _block_view(np.asarray(a), factor)
    *lead, nyc, f1, nxc, f2 = v.shape
    flat = v.swapaxes(-3, -2).reshape(*lead, nyc, nxc, f1 * f2)
    out = np.empty(flat.shape[:-1], dtype=a.dtype)
    it = np.ndindex(*flat.shape[:-1])
    for idx in it:
        vals, counts = np.unique(flat[idx], return_counts=True)
        out[idx] = vals[np.argmax(counts)]
    return out


def block_upsample(a, factor: int):
    """(coarsen.py:869): nearest-neighbor upsampling."""
    xp = _get_xp(a)
    return xp.repeat(xp.repeat(a, factor, axis=-2), factor, axis=-1)


def xarray_block_reduce(a, factor: int, reduction: str = "mean"):
    """compat name (coarsen.py:463)"""
    return block_coarsen(a, factor, reduction)


def horizontal_block_reduce(a, factor: int, reduction: str = "mean"):
    """compat name (coarsen.py:520)"""
    return block_coarsen(a, factor, reduction)
