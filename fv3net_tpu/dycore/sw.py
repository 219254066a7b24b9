"""D-grid vector-invariant shallow-water solver on the cubed sphere.

The 2D core of the FV3 dynamical core (the ``d_sw`` layer of
``fv_dynamics``, reference submodule not in tree): flux-form mass
transport with the Lin-Rood PPM operators, vector-invariant momentum with
cell-centered absolute vorticity fluxed by the *same* transport operators
(Lin & Rood 1997), corner kinetic energy + geopotential gradients, and
forward-backward gravity-wave coupling.  Divergence damping stabilizes
the grid-scale mode as in FV3 (``dddmp``-style 2nd-order damping).

Discrete layout (face-local, [6, ..., j, i]):
    delp  [6, n, n]      cell mass (or fluid depth h for pure SW)
    u     [6, n+1, n]    covariant x-wind on x-directed edges (D grid)
    v     [6, n, n+1]    covariant y-wind on y-directed edges

Metric treatment (round 2): interior C-face winds use the full
covariant->contravariant conversion (FV3's cosa/sina metric; the
round-1 "orthogonal approximation" mis-estimated interior normal winds
by up to cosa*|V| ~ 9 m/s on a 30 m/s jet); tile-boundary faces use a
chart-free reconstruction from each adjacent cell's own edge values and
tangents (the role of FV3's d2a2c edge_vect handling), one-sided at
corner-adjacent rows, with the two stored copies of every shared face
canonicalized (halo.canonicalize_cgrid_boundary) so shared-face fluxes
cancel exactly for arbitrary winds.

Stability design (all certified by the jacfwd eigen-analysis of the
linearized step in tests/test_sw.py -- spectral radius 1 + O(1e-14)):
  * two-stage time-centered substep (the role of FV3's c_sw half step);
  * shared boundary D-edges averaged to stay single-valued
    (halo.average_dgrid_boundary, the mpp domain-symmetry role);
  * all dissipation built as exact vjp-transposes (-c * A^T W A), hence
    provably negative-semidefinite: metric cell-divergence damping
    (div_damp), weak computational corner-divergence damping
    (corner_div_damp), del-4 vorticity damping (vort_damp), and a del-4
    conservative mass filter (scalar_filter).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GRAV
from ..grid.geometry import CubedSphereGrid
from ..grid.halo import (
    average_dgrid_boundary,
    canonicalize_cgrid_boundary,
    halo_exchange,
    halo_exchange_cgrid,
    halo_exchange_dgrid,
)
from ..ops.advection import fv_tp_2d, ppm_flux


class ShallowWaterState(NamedTuple):
    delp: jax.Array  # [6, n, n] fluid depth (m) or mass
    u: jax.Array  # [6, n+1, n]
    v: jax.Array  # [6, n, n+1]


def _shx(a, k):
    return jnp.roll(a, -k, axis=-1)


def _shy(a, k):
    return jnp.roll(a, -k, axis=-2)


@dataclasses.dataclass(frozen=True)
class SWMetrics:
    """Precomputed padded metric terms for the SW step (device arrays)."""

    n: int
    halo: int
    area_px: jax.Array
    area_py: jax.Array
    rarea: jax.Array  # interior 1/area
    dx_u: jax.Array  # edge length at u positions, padded [6, N+1, N]
    dy_v: jax.Array  # edge length at v positions, padded [6, N, N+1]
    dxc_f: jax.Array  # center-center distance at x-faces [6, N, N]
    dyc_f: jax.Array  # at y-faces [6, N, N]
    dy_f: jax.Array  # x-face edge length (for mass flux) [6, N, N]
    dx_f: jax.Array  # y-face edge length [6, N, N]
    f_center: jax.Array  # Coriolis at centers, interior [6, n, n]
    f_px: jax.Array  # Coriolis padded, corner fill x [6, N, N]
    f_py: jax.Array  # corner fill y
    area_c_int: jax.Array  # dual-cell areas at interior corners [6,n+1,n+1]
    # non-orthogonal metric: cos/sin of the angle between the local x and
    # y coordinate directions (FV3's cosa/sina family).  cosa_u/sina_u at
    # x-faces [6, N, N] (face-lattice embedding), cosa_v/sina_v at
    # y-faces, cosa_b/sina_b at corners [6, N+1, N+1].
    cosa_u: jax.Array
    rsin2_u: jax.Array  # 1/sin^2 at x-faces
    cosa_v: jax.Array
    rsin2_v: jax.Array
    cosa_b: jax.Array
    rsin2_b: jax.Array
    dy_fs: jax.Array  # dy * sina at x-faces (effective flux width)
    dx_fs: jax.Array  # dx * sina at y-faces
    sina_u: jax.Array  # sin(angle) at x-faces
    sina_v: jax.Array  # at y-faces
    # chart-free boundary-face C-wind weights: at tile-edge faces the
    # regular 4-point covariant stencil straddles the coordinate kink
    # (errors up to ~40% of the flow near cube corners), so the normal
    # wind there is computed by reconstructing the two adjacent cells'
    # physical vectors from their OWN edge values/tangents and
    # projecting the average onto the face normal -- which collapses to
    # 4 static weights per boundary face (FV3 solves this with the
    # d2a2c edge_vect machinery).  Arrays [6, n, 4] (weights for
    # u1_left, u2_left, u1_right, u2_right cells).
    xbw_w: jax.Array  # x-faces at I = h
    xbw_e: jax.Array  # x-faces at I = h + n
    ybw_s: jax.Array  # y-faces at J = h
    ybw_n: jax.Array
    # cell-centered metric angle (for A-grid KE)
    cosa_c: jax.Array = None  # [6, n, n]
    rsin2_c: jax.Array = None
    # --- within-face tiling support (parallel/tiling.py) -------------
    # When the dycore runs on a tile of a face instead of the whole
    # face, face-EDGE treatments (boundary C-wind weights, cube-vertex
    # KE/geopotential fixes) must fire only on tiles that actually
    # touch that face edge.  None (the face-level default) means "this
    # shard holds whole faces: every edge treatment applies, with the
    # exact pre-tiling code path".  Under tiling these are traced
    # booleans derived from the tile's mesh position.
    edge_w: jax.Array = None
    edge_e: jax.Array = None
    edge_s: jax.Array = None
    edge_n: jax.Array = None
    # 1/multiplicity weights for the corner-lattice damper: number of
    # local lattices (face- AND tile-level) computing each corner
    # point.  None -> the face-level _corner_multiplicity(n).
    inv_corner_mult: jax.Array = None
    # measured operator norm of the metric divergence damper (div_damp)
    divdamp_scale: float = 1.0
    # scheme switches (trace-time constants)
    corner_damp: bool = True  # legacy, unused (damper is metric now)
    metric_ke: bool = True  # covariant-metric KE

    @classmethod
    def make(cls, g: CubedSphereGrid, dtype=jnp.float32,
             metric_cwinds: bool = True, metric_ke: bool = True,
             corner_damp: bool = True) -> "SWMetrics":
        h, n = g.halo, g.n
        N = n + 2 * h
        area_int = jnp.asarray(g.area[g.interior], dtype)
        area_px = halo_exchange(area_int, h, fill="x")
        area_py = halo_exchange(area_int, h, fill="y")

        # distribute edge-lattice metrics with the C-grid machinery so
        # halo+corner values are the neighbors' true metrics.  Metric
        # lengths are positive scalars per edge; exchange |.| of the
        # signed C-grid transport.
        def pad_faces(x_int, y_int, fill):
            ux, vy = halo_exchange_cgrid(
                jnp.asarray(x_int), jnp.asarray(y_int), h, fill=fill
            )
            return jnp.abs(ux), jnp.abs(vy)

        # x-face metrics: dxc (center distance across face), dy (face
        # edge length); y-face: dyc, dx.  Each padded with the corner
        # fill matching the direction of the stencils that consume it.
        dxc_int = g.dxc[:, h : h + n, h : h + n + 1]
        dyc_int = g.dyc[:, h : h + n + 1, h : h + n]
        dyf_int = g.dy[:, h : h + n, h : h + n + 1]
        dxf_int = g.dx[:, h : h + n + 1, h : h + n]
        dxc_p, _ = pad_faces(dxc_int, dyc_int, "x")
        _, dyc_p = pad_faces(dxc_int, dyc_int, "y")
        dyf_p, _ = pad_faces(dyf_int, dxf_int, "x")
        _, dxf_p = pad_faces(dyf_int, dxf_int, "y")

        # u/v-edge lengths (dgrid positions): dx at x-edges, dy at y-edges
        dxu_int = g.dx[:, h : h + n + 1, h : h + n]
        dyv_int = g.dy[:, h : h + n, h : h + n + 1]
        dxu_p, dyv_p = halo_exchange_dgrid(
            jnp.asarray(dxu_int), jnp.asarray(dyv_int), h
        )
        dxu_p = jnp.where(jnp.abs(dxu_p) > 0, jnp.abs(dxu_p), 1.0)
        dyv_p = jnp.where(jnp.abs(dyv_p) > 0, jnp.abs(dyv_p), 1.0)

        def face_embed_x(a):
            return jnp.asarray(np.asarray(a)[:, :, :N], dtype)

        def face_embed_y(a):
            return jnp.asarray(np.asarray(a)[:, :N, :], dtype)

        # --- non-orthogonality angles --------------------------------
        # at a point with unit coordinate directions e1 (x) and e2 (y),
        # cosa = e1 . e2; fluxes/KE need 1/sin^2 = 1/(1 - cosa^2)
        cor = g.corners_xyz  # padded [6, N+1, N+1, 3]
        cen = g.centers_xyz

        def unit(v):
            nrm = np.linalg.norm(v, axis=-1, keepdims=True)
            return v / np.where(nrm > 0, nrm, 1.0)

        # x-faces (j, I): e2 = corner(j+1,I)-corner(j,I) (the edge),
        # e1 = center(j,I)-center(j,I-1) (crossing direction)
        e2_u = unit(cor[:, 1:, :, :] - cor[:, :-1, :, :])  # [6, N, N+1]
        e1_u = unit(cen[:, :, 1:, :] - cen[:, :, :-1, :])  # [6, N, N-1]
        cosa_u = np.zeros((6, N, N))
        cosa_u[:, :, 1:] = np.sum(
            e1_u * e2_u[:, :, 1:-1, :], axis=-1
        )
        # y-faces (J, i): e1 = corner(J,i+1)-corner(J,i),
        # e2 = center(J,i)-center(J-1,i)
        e1_v = unit(cor[:, :, 1:, :] - cor[:, :, :-1, :])  # [6, N+1, N]
        e2_v = unit(cen[:, 1:, :, :] - cen[:, :-1, :, :])  # [6, N-1, N]
        cosa_v = np.zeros((6, N, N))
        cosa_v[:, 1:, :] = np.sum(
            e1_v[:, 1:-1, :, :] * e2_v, axis=-1
        )
        # corners (J, I): e1 along x (corner row), e2 along y
        e1_b = unit(cor[:, :, 2:, :] - cor[:, :, :-2, :])  # [6,N+1,N-1]
        e2_b = unit(cor[:, 2:, :, :] - cor[:, :-2, :, :])  # [6,N-1,N+1]
        cosa_b = np.zeros((6, N + 1, N + 1))
        cosa_b[:, 1:-1, 1:-1] = np.sum(
            e1_b[:, 1:-1, :, :] * e2_b[:, :, 1:-1, :], axis=-1
        )

        def clean_angle(c):
            c = np.where(np.isfinite(c), c, 0.0)
            c = np.clip(c, -0.8, 0.8)
            return c, 1.0 / (1.0 - c * c)

        cosa_u, rsin2_u = clean_angle(cosa_u)
        cosa_v, rsin2_v = clean_angle(cosa_v)
        cosa_b, rsin2_b = clean_angle(cosa_b)

        # --- boundary-face weights (chart-free reconstruction) -------
        def unit_np(vv):
            nn = np.linalg.norm(vv, axis=-1, keepdims=True)
            return vv / np.where(nn > 0, nn, 1.0)

        def cell_tangents(j, i):
            """Unit coordinate tangents of padded cell (j, i) from its
            own 4 edges (chart-free)."""
            tx = unit_np(
                (cor[:, j, i + 1] - cor[:, j, i])
                + (cor[:, j + 1, i + 1] - cor[:, j + 1, i])
            )
            ty = unit_np(
                (cor[:, j + 1, i] - cor[:, j, i])
                + (cor[:, j + 1, i + 1] - cor[:, j, i + 1])
            )
            return tx, ty  # [6, 3] each (vectorizable over j)

        def cell_tangents_col(i):
            # all padded rows j = 0..N-1 at column i -> [6, N, 3]
            tx = unit_np(
                (cor[:, :-1, i + 1] - cor[:, :-1, i])
                + (cor[:, 1:, i + 1] - cor[:, 1:, i])
            )
            ty = unit_np(
                (cor[:, 1:, i] - cor[:, :-1, i])
                + (cor[:, 1:, i + 1] - cor[:, :-1, i + 1])
            )
            return tx, ty

        def cell_tangents_row(j):
            tx = unit_np(
                (cor[:, j, 1:] - cor[:, j, :-1])
                + (cor[:, j + 1, 1:] - cor[:, j + 1, :-1])
            )
            ty = unit_np(
                (cor[:, 1 + j, :-1] - cor[:, j, :-1])
                + (cor[:, 1 + j, 1:] - cor[:, j, 1:])
            )
            return tx, ty

        def recon_coeffs(tx, ty):
            """C1, C2 with V = C1*u1 + C2*u2 given covariant (u1,u2)."""
            ca = np.sum(tx * ty, axis=-1, keepdims=True)
            det = np.maximum(1.0 - ca * ca, 1e-6)
            C1 = (tx - ca * ty) / det
            C2 = (ty - ca * tx) / det
            return C1, C2

        def xface_weights(I):
            """Weights for x-faces at padded column I, interior rows."""
            rows = slice(h, h + n)
            txL, tyL = cell_tangents_col(I - 1)
            txR, tyR = cell_tangents_col(I)
            C1L, C2L = recon_coeffs(txL[:, rows], tyL[:, rows])
            C1R, C2R = recon_coeffs(txR[:, rows], tyR[:, rows])
            # face normal & sina at (rows, I)
            edge = cor[:, h + 1 : h + n + 1, I] - cor[:, h : h + n, I]
            midp = unit_np(
                cor[:, h + 1 : h + n + 1, I] + cor[:, h : h + n, I]
            )
            nrm = unit_np(np.cross(edge, midp))
            sina_f = np.sqrt(
                np.maximum(1.0 - cosa_u[:, h : h + n, I] ** 2, 0.2)
            )[..., None]
            half_over_sina = 0.5 / sina_f
            w = np.stack(
                [
                    np.sum(C1L * nrm, axis=-1),
                    np.sum(C2L * nrm, axis=-1),
                    np.sum(C1R * nrm, axis=-1),
                    np.sum(C2R * nrm, axis=-1),
                ],
                axis=-1,
            ) * half_over_sina  # [6, n, 4]
            # corner-adjacent rows: one-sided from the INTERIOR cell
            # (the halo cell's covariant means contain corner-substituted
            # D-wind slots -- garbage inputs)
            interior_right = I == h  # west boundary: interior is right
            lo, hi = (2, 4) if interior_right else (0, 2)
            for r in (0, n - 1):
                w[:, r, :] = 0.0
                w[:, r, lo:hi] = (
                    np.stack(
                        [np.sum((C1R if interior_right else C1L)[:, r]
                                * nrm[:, r], -1),
                         np.sum((C2R if interior_right else C2L)[:, r]
                                * nrm[:, r], -1)], -1,
                    ) / sina_f[:, r]
                )
            return w

        def yface_weights(J):
            cols = slice(h, h + n)
            txL, tyL = cell_tangents_row(J - 1)
            txR, tyR = cell_tangents_row(J)
            C1L, C2L = recon_coeffs(txL[:, cols], tyL[:, cols])
            C1R, C2R = recon_coeffs(txR[:, cols], tyR[:, cols])
            edge = cor[:, J, h + 1 : h + n + 1] - cor[:, J, h : h + n]
            midp = unit_np(
                cor[:, J, h + 1 : h + n + 1] + cor[:, J, h : h + n]
            )
            nrm = unit_np(np.cross(midp, edge))
            sina_f = np.sqrt(
                np.maximum(1.0 - cosa_v[:, J, h : h + n] ** 2, 0.2)
            )[..., None]
            half_over_sina = 0.5 / sina_f
            w = np.stack(
                [
                    np.sum(C1L * nrm, axis=-1),
                    np.sum(C2L * nrm, axis=-1),
                    np.sum(C1R * nrm, axis=-1),
                    np.sum(C2R * nrm, axis=-1),
                ],
                axis=-1,
            ) * half_over_sina
            interior_right = J == h  # south boundary: interior is north
            lo, hi = (2, 4) if interior_right else (0, 2)
            for r in (0, n - 1):
                w[:, r, :] = 0.0
                w[:, r, lo:hi] = (
                    np.stack(
                        [np.sum((C1R if interior_right else C1L)[:, r]
                                * nrm[:, r], -1),
                         np.sum((C2R if interior_right else C2L)[:, r]
                                * nrm[:, r], -1)], -1,
                    ) / sina_f[:, r]
                )
            return w

        xbw_w = xface_weights(h)
        xbw_e = xface_weights(h + n)
        ybw_s = yface_weights(h)
        ybw_n = yface_weights(h + n)
        # boundary weights yield CONTRAVARIANT normal winds (V.n / sina,
        # the half_over_sina factor above), consistent with the interior
        # metric conversion; fluxes then use the dy*sina effective width
        # everywhere.  (Round 1 zeroed the interior cosa/sina metric --
        # the "orthogonal approximation" -- which mis-estimates interior
        # C-winds by up to cosa*|V| ~ 9 m/s on a 30 m/s jet and drove
        # the cube-corner mass pumping that xfailed the JW06 test.)
        sina_u_np = np.sqrt(np.maximum(1.0 - cosa_u ** 2, 0.2))
        sina_v_np = np.sqrt(np.maximum(1.0 - cosa_v ** 2, 0.2))
        if not metric_cwinds:
            # legacy round-1 orthogonal approximation (kept for A/B
            # comparison): zero the metric, unit flux widths, boundary
            # weights baked with sina so fluxes stay exact
            xbw_w = xbw_w * sina_u_np[:, h : h + n, h][..., None]
            xbw_e = xbw_e * sina_u_np[:, h : h + n, h + n][..., None]
            ybw_s = ybw_s * sina_v_np[:, h, h : h + n][..., None]
            ybw_n = ybw_n * sina_v_np[:, h + n, h : h + n][..., None]
            cosa_u = cosa_u * 0.0
            rsin2_u = rsin2_u * 0.0 + 1.0
            cosa_v = cosa_v * 0.0
            rsin2_v = rsin2_v * 0.0 + 1.0
            sina_u_np = np.ones_like(sina_u_np)
            sina_v_np = np.ones_like(sina_v_np)
        if not metric_ke:
            cosa_b = cosa_b * 0.0
            rsin2_b = rsin2_b * 0.0 + 1.0

        # cell-centered coordinate angle for the A-grid KE
        e1_c = unit(cen[:, :, 2:, :] - cen[:, :, :-2, :])
        e2_c = unit(cen[:, 2:, :, :] - cen[:, :-2, :, :])
        cosa_cell = np.sum(
            e1_c[:, 1:-1, :, :] * e2_c[:, :, 1:-1, :], axis=-1
        )[:, h - 1 : h - 1 + n, h - 1 : h - 1 + n]
        cosa_cell, rsin2_cell = clean_angle(cosa_cell)
        if not metric_ke:
            cosa_cell = cosa_cell * 0.0
            rsin2_cell = rsin2_cell * 0.0 + 1.0

        fc = jnp.asarray(g.f_center[g.interior], dtype)
        self = cls(
            n=n,
            halo=h,
            area_px=area_px,
            area_py=area_py,
            rarea=1.0 / area_int,
            dx_u=jnp.asarray(dxu_p, dtype),
            dy_v=jnp.asarray(dyv_p, dtype),
            dxc_f=face_embed_x(dxc_p),
            dyc_f=face_embed_y(dyc_p),
            dy_f=face_embed_x(dyf_p),
            dx_f=face_embed_y(dxf_p),
            f_center=fc,
            f_px=halo_exchange(fc, h, fill="x"),
            f_py=halo_exchange(fc, h, fill="y"),
            area_c_int=jnp.asarray(
                g.area_c[:, h : h + n + 1, h : h + n + 1], dtype
            ),
            cosa_u=jnp.asarray(cosa_u, dtype),
            rsin2_u=jnp.asarray(rsin2_u, dtype),
            cosa_v=jnp.asarray(cosa_v, dtype),
            rsin2_v=jnp.asarray(rsin2_v, dtype),
            cosa_b=jnp.asarray(cosa_b, dtype),
            rsin2_b=jnp.asarray(rsin2_b, dtype),
            dy_fs=face_embed_x(dyf_p) * jnp.asarray(sina_u_np, dtype),
            dx_fs=face_embed_y(dxf_p) * jnp.asarray(sina_v_np, dtype),
            sina_u=jnp.asarray(sina_u_np, dtype),
            sina_v=jnp.asarray(sina_v_np, dtype),
            xbw_w=jnp.asarray(xbw_w, dtype),
            xbw_e=jnp.asarray(xbw_e, dtype),
            ybw_s=jnp.asarray(ybw_s, dtype),
            ybw_n=jnp.asarray(ybw_n, dtype),
            cosa_c=jnp.asarray(cosa_cell, dtype),
            rsin2_c=jnp.asarray(rsin2_cell, dtype),
            corner_damp=corner_damp,
            metric_ke=metric_ke,
        )
        # --- divergence-damper normalization --------------------------
        # power iteration for the largest eigenvalue of the symmetric
        # PSD operator T = M^T(A M .), M = linear_mass_div; div_damp
        # scales T by 8/lambda_max so d2 keeps the familiar
        # forward-Euler limit of 1/4 for a nondimensional Laplacian.
        area_j = jnp.asarray(1.0 / np.asarray(self.rarea), dtype)

        def T(uu, vv):
            div, vjp_fn = jax.vjp(
                lambda a, b: linear_mass_div(a, b, self), uu, vv
            )
            return vjp_fn(div * area_j)

        # jit the whole 30-step power iteration: tracing T
        # interpretively per step dominated stepper-construction time.
        # Pinned to the host CPU backend: it runs once at build time
        # for a scalar.
        @jax.jit
        def power_iteration(uu, vv):
            def body(_, carry):
                uu, vv, _ = carry
                uu, vv = T(uu, vv)
                lam = jnp.sqrt(jnp.sum(uu ** 2) + jnp.sum(vv ** 2))
                return uu / lam, vv / lam, lam

            return jax.lax.fori_loop(
                0, 30, body, (uu, vv, jnp.array(1.0, dtype))
            )[2]

        rng = np.random.RandomState(0)
        try:
            cpu = jax.local_devices(backend="cpu")[0]  # local: in
            # multi-process mode jax.devices() is GLOBAL and
            # entry [0] may be another process's device
        except RuntimeError:
            cpu = None
        with jax.default_device(cpu):
            uu = jnp.asarray(rng.randn(6, n + 1, n), dtype)
            vv = jnp.asarray(rng.randn(6, n, n + 1), dtype)
            lam = float(power_iteration(uu, vv))
        if not np.isfinite(lam) or lam <= 0:
            raise RuntimeError("divergence-damper normalization failed")
        return dataclasses.replace(self, divdamp_scale=8.0 / lam)


FILTER_COEF = 0.02
VORT_DAMP_COEF = 0.02


def vertex_masks(m: "SWMetrics"):
    """Cube-vertex applicability masks in ((h,h),(h,hn),(hn,h),(hn,hn))
    = (SW, SE, NW, NE) order; (None,)*4 at face level (always apply)."""
    if m.edge_w is None:
        return (None,) * 4
    return (
        jnp.logical_and(m.edge_s, m.edge_w),
        jnp.logical_and(m.edge_s, m.edge_e),
        jnp.logical_and(m.edge_n, m.edge_w),
        jnp.logical_and(m.edge_n, m.edge_e),
    )


def _masked_vertex_set(arr, idx, val, mask):
    """arr with entry [..., cj, ci] replaced by val, gated by an
    optional traced mask.

    Implemented as a one-hot select instead of ``arr.at[cj, ci].set``:
    a point scatter is a fusion boundary for XLA (the whole array is
    materialized through HBM around it), while the select fuses into
    the surrounding elementwise chains -- the substep runs ~20 such
    vertex fixes on full 3D corner lattices (profile
    tools/PROFILE_C192_r5.md, the "long tail").
    """
    cj, ci = idx
    A, B = arr.shape[-2], arr.shape[-1]
    oh = jnp.logical_and(
        jnp.arange(A)[:, None] == cj, jnp.arange(B)[None, :] == ci
    )
    if mask is not None:
        oh = jnp.logical_and(oh, mask)
    return jnp.where(oh, val[..., None, None], arr)


def linear_mass_div(u, v, m):
    """The linear map winds -> unit-depth mass divergence per cell.

    Exactly the linearization (at rest) of the PPM mass transport:
    C-grid contravariant winds via c_grid_winds + boundary
    canonicalization + exchange, physical flux widths dy*sina, area
    divergence.  Used both directly and -- transposed via jax.vjp --
    as the pressure-gradient operator (see pgf_grad).
    """
    up, vp = halo_exchange_dgrid(u, v, m.halo)
    return _mass_div_from_padded(up, vp, m)


def _mass_div_from_padded(up, vp, m):
    """linear_mass_div body after the D-grid exchange (shared with the
    combined damper so one exchange feeds several operators)."""
    h, n = m.halo, m.n
    N = n + 2 * h
    lead = up.ndim - 3  # level axes between face and spatial dims

    def bc(a):
        return a.reshape(a.shape[:1] + (1,) * lead + a.shape[1:])

    uc_A, vc_A = c_grid_winds(up, vp, m)
    uc_int = uc_A[..., h : h + n, h : h + n + 1]
    vc_int = vc_A[..., h : h + n + 1, h : h + n]
    uc_int, vc_int = canonicalize_cgrid_boundary(uc_int, vc_int)
    ucx_p, _ = halo_exchange_cgrid(uc_int, vc_int, h, fill="x")
    _, vcy_p = halo_exchange_cgrid(uc_int, vc_int, h, fill="y")
    uc = ucx_p[..., :, :N]
    vc = vcy_p[..., :N, :]
    fx = uc * bc(m.dy_fs)
    fy = vc * bc(m.dx_fs)
    div = (fx - _shx(fx, 1)) + (fy - _shy(fy, 1))
    return div[..., h : h + n, h : h + n] * bc(m.rarea)


def _cell_grad_op(q, m):
    """Simple cell->face difference operator (annihilates constants):
    returns (sx [6,...,n,n+1], sy [6,...,n+1,n]) interior+boundary face
    differences from fill-corner halo exchanges."""
    h, n = m.halo, m.n
    qx = halo_exchange(q, h, fill="x")
    qy = halo_exchange(q, h, fill="y")
    sx = (
        qx[..., h : h + n, h : h + n + 1]
        - qx[..., h : h + n, h - 1 : h + n]
    )
    sy = (
        qy[..., h : h + n + 1, h : h + n]
        - qy[..., h - 1 : h + n, h : h + n]
    )
    return sx, sy


def scalar_filter(q, m, c):
    """Conservative, provably dissipative del-2 filter on a cell scalar:
    q - c * (1/area) G^T(G q), G the cell->face difference (jax.vjp
    transpose, so the operator is symmetric negative-semidefinite in
    the area-weighted norm; G(const)=0 makes it exactly conservative).

    Role: FV3 relies on its energy-consistent corner machinery plus
    nord>0 damping to keep cube-corner mass modes neutral; this
    framework's linearized step retains a weak (~0.6%/substep) growing
    boundary-ring mass mode (measured by the jacfwd eigen-analysis in
    tests/test_sw.py).  A tiny background 2-delta filter (c ~ 0.02 =
    16%/substep damping of the sawtooth, O(c k^2 dx^2) on smooth
    fields) stabilizes it with negligible smoothing of resolved flow.
    """
    if c == 0.0:
        return q
    h, n = m.halo, m.n
    # face weights = mean adjacent cell area, making (1/area) G^T(w G)
    # nondimensional with Laplacian-like eigenvalues <= ~8
    wfx = 0.5 * (
        m.area_px[:, h : h + n, h - 1 : h + n]
        + m.area_px[:, h : h + n, h : h + n + 1]
    )
    wfy = 0.5 * (
        m.area_py[:, h - 1 : h + n, h : h + n]
        + m.area_py[:, h : h + n + 1, h : h + n]
    )
    # Within-face tiling: each tile computes its local faces 0..n, so a
    # face on an interior tile boundary is computed by BOTH adjacent
    # tiles (like inter-FACE faces at face level, which the operator
    # intentionally counts once per face).  Halve those shared weights
    # so the assembled G^T(W G) equals the face-level operator exactly
    # (both copies are bit-identical, and vjp-through-ppermute sums the
    # two half-contributions).
    if m.edge_w is not None:
        icol = jnp.arange(n + 1)
        colw = jnp.where(
            (icol == 0) & ~m.edge_w, 0.5, 1.0
        ) * jnp.where((icol == n) & ~m.edge_e, 0.5, 1.0)
        roww = jnp.where(
            (icol == 0) & ~m.edge_s, 0.5, 1.0
        ) * jnp.where((icol == n) & ~m.edge_n, 0.5, 1.0)
        wfx = wfx * colw
        wfy = wfy * roww[:, None]
    lead = q.ndim - 3  # level axes between face and spatial dims

    def bc(a):
        return a.reshape(a.shape[:1] + (1,) * lead + a.shape[1:])

    def L(qq):
        (sx, sy), vjp = jax.vjp(lambda x: _cell_grad_op(x, m), qq)
        (dq,) = vjp((sx * bc(wfx), sy * bc(wfy)))
        return dq * bc(m.rarea)

    def L_local(qq):
        # The vjp-assembled G^T(W G) written as an explicit flux-form
        # Laplacian: every face flux t = w * dq is subtracted/added to
        # its two adjacent cells, and inter-face boundary faces —
        # computed by BOTH adjacent faces, once each — carry doubled
        # weight.  Exact same operator (same sums, no autodiff
        # scatter, which the vjp-of-gather transpose would be);
        # equality is asserted by
        # tests/test_sw.py::test_scalar_filter_local_form.
        sx, sy = _cell_grad_op(qq, m)
        tx = sx * bc(wfx)
        ty = sy * bc(wfy)
        tx = jnp.concatenate(
            [2.0 * tx[..., :1], tx[..., 1:-1], 2.0 * tx[..., -1:]],
            axis=-1,
        )
        ty = jnp.concatenate(
            [2.0 * ty[..., :1, :], ty[..., 1:-1, :],
             2.0 * ty[..., -1:, :]],
            axis=-2,
        )
        dq = (tx[..., :, :-1] - tx[..., :, 1:]) + (
            ty[..., :-1, :] - ty[..., 1:, :]
        )
        return dq * bc(m.rarea)

    if m.edge_w is None:  # face level: forward-only local form
        L = L_local

    # del-4 (L^2/8): 2-delta damped at ~8c, resolved scales (k dx)^2
    # weaker than the del-2 form; conservative and dissipative for any
    # composition of the self-adjoint PSD L
    return q - (c / 8.0) * L(L(q))


def vort_damp(u, v, m, cv):
    """Vorticity-damping wind increments: -cv * V^T(V u), V the
    nondimensional cell circulation (plain edge differences, face-local,
    no halo).  Symmetric negative-semidefinite by vjp construction.
    Role of FV3's do_vort_damp/Smagorinsky family: the Coriolis term
    enters through the vorticity flux, whose staggered metric averaging
    is not discretely skew at face boundaries -- jacfwd eigenanalysis
    shows boundary-ring wind-sawtooth modes pumped at ~f*dt*cosa
    (~0.4%%/substep); a weak curl damper (8*cv per 2-delta mode)
    removes them while leaving resolved rotational flow O(cv k^2 dx^2).
    """
    if cv == 0.0:
        return jnp.zeros_like(u), jnp.zeros_like(v)
    h, n = m.halo, m.n

    # Circulation cells via exchanged winds, cropped to OWN cells: at
    # face level this is bit-equivalent to the plain local differences
    # (own-cell inputs are pass-through positions of the D exchange),
    # but under within-face tiling the vjp then routes each cell's
    # cotangent through the ppermute transpose to the canonical owner
    # of every wind slot it touches -- the exact global adjoint, where
    # a tile-local form would drop the cross-tile contributions.
    def Vop(uu, vv):
        up, vp = halo_exchange_dgrid(uu, vv, h)
        z = (
            up[..., :-1, :] - up[..., 1:, :]
            + vp[..., :, 1:] - vp[..., :, :-1]
        )
        return z[..., h : h + n, h : h + n]

    # Face level: Vop consumes ONLY own wind slots (the crop keeps
    # rows/cols h..h+n, all pass-through positions of the D exchange),
    # so both Vop and its transpose are plain local stencils — the
    # exchange exists purely so the vjp routes cross-TILE adjoint
    # contributions under within-face tiling.  The forward-only local
    # pair below is the exact same operator (asserted by
    # tests/test_sw.py::test_vort_damp_local_form) without the
    # autodiff scatter.
    def Vop_local(uu, vv):
        return (
            uu[..., :-1, :] - uu[..., 1:, :]
            + vv[..., :, 1:] - vv[..., :, :-1]
        )

    def VT_local(t):
        zj = jnp.zeros_like(t[..., :1, :])
        zi = jnp.zeros_like(t[..., :, :1])
        du = jnp.concatenate([t, zj], axis=-2) - jnp.concatenate(
            [zj, t], axis=-2
        )
        dv = jnp.concatenate([zi, t], axis=-1) - jnp.concatenate(
            [t, zi], axis=-1
        )
        return du, dv

    if m.edge_w is None:  # face level: forward-only local del-4
        du1, dv1 = VT_local(Vop_local(u, v))
        du, dv = VT_local(Vop_local(du1, dv1))
        return -(cv / 8.0) * du, -(cv / 8.0) * dv

    # del-4 form (V^T V)^2 / 8: same 2-delta strength as del-2 with
    # coefficient cv (8*cv per substep) but ~(k dx)^2 weaker on
    # resolved scales -- the del-2 form decayed a 10-cell jet at
    # ~0.3/day, destroying the JW06 baseline
    z, vjp = jax.vjp(Vop, u, v)
    du1, dv1 = vjp(z)
    z2, vjp2 = jax.vjp(Vop, du1, dv1)
    du, dv = vjp2(z2)
    return -(cv / 8.0) * du, -(cv / 8.0) * dv


CORNER_DAMP_COEF = 0.02


@lru_cache(maxsize=None)
def _corner_multiplicity(n: int):
    """How many faces compute each physical corner point of one face's
    own (n+1, n+1) corner lattice: 1 interior, 2 on shared edges, 3 at
    cube vertices."""
    w = np.ones((n + 1, n + 1))
    w[0, :] = w[-1, :] = 2.0
    w[:, 0] = w[:, -1] = 2.0
    w[0, 0] = w[0, -1] = w[-1, 0] = w[-1, -1] = 3.0
    return w


def _div_b_op(u, v, m):
    """B-grid (corner-lattice) computational divergence: plain
    covariant-difference 4-term form on the padded D winds, cropped to
    this face's own corners [6, ..., n+1, n+1].  At cube-corner
    vertices the D-halo tables resolve the beyond-corner slots to the
    real third edge; the result matches an analytic potential flow to
    ~1%."""
    up, vp = halo_exchange_dgrid(u, v, m.halo)
    return _div_b_from_padded(up, vp, m)


def _div_b_from_padded(up, vp, m):
    h, n = m.halo, m.n
    lead = [(0, 0)] * (up.ndim - 2)
    u_pad = jnp.pad(up, lead + [(0, 0), (1, 1)])
    v_pad = jnp.pad(vp, lead + [(1, 1), (0, 0)])
    div_b = (u_pad[..., :, 1:] - u_pad[..., :, :-1]) + (
        v_pad[..., 1:, :] - v_pad[..., :-1, :]
    )
    return div_b[..., h : h + n + 1, h : h + n + 1]


def corner_div_damp(u, v, m, c):
    """Weak corner-lattice divergence damper: -c * D^T(W D u), D the
    computational (covariant-difference) corner divergence, W =
    1/multiplicity.  Symmetric negative-semidefinite by vjp
    construction.

    Complements div_damp: the metric cell-divergence damper is blind to
    modes in the null space of the D->C interpolation (the jacfwd
    eigen-analysis shows a residual 3e-4/substep boundary mode with it
    alone), while this computational form covers the full wind space.
    Because covariant components jump identity across the inter-face
    kink, D sees an O(cosa*V) spurious signal on smooth flows at the
    boundary ring, so c is kept small (the smooth-flow kick scales as
    ~0.7 m/s per step per 0.01 of c at C24, one-step JW06 balance
    diagnostic); the heavy lifting is done by the metric damper.
    """
    if c == 0.0:
        return jnp.zeros_like(u), jnp.zeros_like(v)
    if m.inv_corner_mult is not None:
        im = m.inv_corner_mult  # [1 or L, nl+1, nl+1] per-tile weights
        lead = u.ndim - 3
        inv_mult = im.reshape(
            im.shape[:1] + (1,) * lead + im.shape[1:]
        ).astype(u.dtype)
    else:
        inv_mult = jnp.asarray(1.0 / _corner_multiplicity(m.n), u.dtype)
    div, vjp = jax.vjp(lambda uu, vv: _div_b_op(uu, vv, m), u, v)
    du, dv = vjp(div * inv_mult)
    return -c * du, -c * dv


def div_damp(u, v, m, d2):
    """Divergence-damping wind increments: -d2*(8/lam) * M^T(A M u),
    M = linear_mass_div (the TRUE metric cell divergence), A = area,
    lam the measured largest eigenvalue (SWMetrics.divdamp_scale).

    Symmetric negative-semidefinite by vjp construction -- provably
    dissipative for any cube topology/halo sign convention -- and,
    because M is a metric divergence, it vanishes on smooth
    non-divergent flow INCLUDING across face boundaries.  (Round 1
    damped the nondimensional covariant-difference corner divergence;
    the covariant components jump identity across the inter-face kink,
    so a smooth balanced jet saw an O(cosa*V) spurious divergence at
    the boundary ring and received an 8 m/s/step spurious kick --
    measured by the one-step JW06 balance diagnostic.)
    """
    if d2 == 0.0:
        return jnp.zeros_like(u), jnp.zeros_like(v)
    lead = u.ndim - 3
    area = (1.0 / m.rarea).reshape(
        m.rarea.shape[:1] + (1,) * lead + m.rarea.shape[1:]
    )
    div, vjp = jax.vjp(lambda uu, vv: linear_mass_div(uu, vv, m), u, v)
    du, dv = vjp(div * area)
    c = d2 * m.divdamp_scale
    return -c * du, -c * dv


def c_grid_winds(up, vp, m):
    """Contravariant C-face winds from padded D-grid winds.

    Interior faces: 4-point covariant average + metric conversion.
    Tile-boundary faces: chart-free reconstruction via the precomputed
    boundary weights (see SWMetrics), because the regular stencil
    straddles the inter-face coordinate kink (up to ~40% normal-wind
    error near cube corners, which pumps mass).
    up/vp may carry leading level axes before the two spatial axes.
    """
    h, n = m.halo, m.n
    N = n + 2 * h
    lead = up.ndim - 3  # number of axes between face and spatial dims

    def bc(a):  # broadcast metric over leading level axes
        return a.reshape(a.shape[:1] + (1,) * lead + a.shape[1:])

    u_l = up[..., :-1, :]
    u_u = up[..., 1:, :]
    uc_cov = 0.25 * (_shx(u_l, -1) + u_l + _shx(u_u, -1) + u_u)
    v_l = vp[..., :, :-1]
    v_u = vp[..., :, 1:]
    vc_cov = 0.25 * (_shy(v_l, -1) + v_l + _shy(v_u, -1) + v_u)

    uc_A = (uc_cov - bc(m.cosa_u) * vp[..., :, :N]) * bc(m.rsin2_u)
    vc_A = (vc_cov - bc(m.cosa_v) * up[..., :N, :]) * bc(m.rsin2_v)

    # --- boundary faces: V = C1*u1 + C2*u2 per adjacent cell, averaged
    # and projected on the face normal (weights precomputed) ----------
    rows = slice(h, h + n)
    u1c = 0.5 * (up[..., :-1, :] + up[..., 1:, :])  # cell mean of u
    u2c = 0.5 * (vp[..., :, :-1] + vp[..., :, 1:])  # cell mean of v

    def xpatch(I, w):
        a = (
            bc(w[..., 0]) * u1c[..., rows, I - 1]
            + bc(w[..., 1]) * u2c[..., rows, I - 1]
            + bc(w[..., 2]) * u1c[..., rows, I]
            + bc(w[..., 3]) * u2c[..., rows, I]
        )
        return a

    # boundary patches placed with one-hot selects, not .at[].set:
    # a column scatter is a fusion boundary (whole-array HBM
    # materialization); the select fuses into the metric-conversion
    # chain (see _masked_vertex_set)
    idxN = jnp.arange(N)
    row_in = jnp.logical_and(idxN >= h, idxN < h + n)

    def _pad_patch(patch):
        return jnp.pad(
            patch, [(0, 0)] * (patch.ndim - 1) + [(h, N - h - n)]
        )

    def put_col(arr, I, patch, mask):
        oh = jnp.logical_and(row_in[:, None], idxN[None, :] == I)
        if mask is not None:
            oh = jnp.logical_and(oh, mask)
        return jnp.where(oh, _pad_patch(patch)[..., :, None], arr)

    uc_A = put_col(uc_A, h, xpatch(h, m.xbw_w), m.edge_w)
    uc_A = put_col(uc_A, h + n, xpatch(h + n, m.xbw_e), m.edge_e)

    def ypatch(J, w):
        return (
            bc(w[..., 0]) * u1c[..., J - 1, rows]
            + bc(w[..., 1]) * u2c[..., J - 1, rows]
            + bc(w[..., 2]) * u1c[..., J, rows]
            + bc(w[..., 3]) * u2c[..., J, rows]
        )

    def put_row(arr, J, patch, mask):
        oh = jnp.logical_and(idxN[:, None] == J, row_in[None, :])
        if mask is not None:
            oh = jnp.logical_and(oh, mask)
        return jnp.where(oh, _pad_patch(patch)[..., None, :], arr)

    vc_A = put_row(vc_A, h, ypatch(h, m.ybw_s), m.edge_s)
    vc_A = put_row(vc_A, h + n, ypatch(h + n, m.ybw_n), m.edge_n)
    return uc_A, vc_A


def padded_cgrid_winds(u, v, m: "SWMetrics", up=None, vp=None):
    """Canonical contravariant C-face winds on the padded lattices.

    The c_grid_winds + boundary-canonicalization + C-grid-exchange
    chain shared by the D stage and the cheap C half-stage.  Returns
    (uc, vc, vc_on_x, uc_on_y): uc on the x-face lattice (fill='x'),
    vc on the y-face lattice (fill='y'), plus each wind's partner from
    the OTHER fill (consumed by the half-stage tangential averages).
    """
    h, n = m.halo, m.n
    N = n + 2 * h
    if up is None:
        up, vp = halo_exchange_dgrid(u, v, h)
    uc_A, vc_A = c_grid_winds(up, vp, m)
    uc_int = uc_A[..., h : h + n, h : h + n + 1]
    vc_int = vc_A[..., h : h + n + 1, h : h + n]
    uc_int, vc_int = canonicalize_cgrid_boundary(uc_int, vc_int)
    ucx_p, vcx_p = halo_exchange_cgrid(uc_int, vc_int, h, fill="x")
    ucy_p, vcy_p = halo_exchange_cgrid(uc_int, vc_int, h, fill="y")
    return (
        ucx_p[..., :, :N],
        vcy_p[..., :N, :],
        vcx_p[..., :N, :],
        ucy_p[..., :, :N],
    )


def _c_half_winds_common(uc, vc, vc_on_x, uc_on_y, up, vp, m):
    """Geometry-only pieces of the C half-stage wind update, shared by
    the 2D and 3D forms: cell-mean winds, cell KE, absolute vorticity
    (all on the padded lattice), plus the face-tangential winds."""
    lead = up.ndim - 3

    def bc(a):
        return a.reshape(a.shape[:1] + (1,) * lead + a.shape[1:])

    # cell-mean contravariant winds and (orthogonal-approx) KE
    ub = 0.5 * (uc + _shx(uc, 1))
    vb = 0.5 * (vc + _shy(vc, 1))
    ke = 0.5 * (ub * ub + vb * vb)
    # absolute vorticity at cell centers (padded; circulation of the
    # covariant D winds over the padded metric lengths)
    udx = up * bc(m.dx_u)
    vdy = vp * bc(m.dy_v)
    vort = (
        udx[..., :-1, :] - udx[..., 1:, :]
        + vdy[..., :, 1:] - vdy[..., :, :-1]
    )
    rarea_p = 1.0 / bc(m.area_px)
    zeta = vort * rarea_p + bc(m.f_px)
    # face-mean absolute vorticity and tangential winds
    zf_u = 0.5 * (zeta + _shx(zeta, -1))
    zf_v = 0.5 * (zeta + _shy(zeta, -1))
    vbar_u = 0.25 * (
        vc_on_x + _shy(vc_on_x, 1)
        + _shx(vc_on_x, -1) + _shx(_shy(vc_on_x, 1), -1)
    )
    ubar_v = 0.25 * (
        uc_on_y + _shx(uc_on_y, 1)
        + _shy(uc_on_y, -1) + _shy(_shx(uc_on_y, 1), -1)
    )
    return bc, ke, rarea_p, zf_u, zf_v, vbar_u, ubar_v


def _finish_c_half(uc, vc, duc, dvc, m: "SWMetrics"):
    """Crop the updated C winds to own faces, re-canonicalize the
    shared tile-boundary copies, and redistribute both fills."""
    h, n = m.halo, m.n
    N = n + 2 * h
    uc_i = (uc + duc)[..., h : h + n, h : h + n + 1]
    vc_i = (vc + dvc)[..., h : h + n + 1, h : h + n]
    uc_i, vc_i = canonicalize_cgrid_boundary(uc_i, vc_i)
    ucx_p, _ = halo_exchange_cgrid(uc_i, vc_i, h, fill="x")
    _, vcy_p = halo_exchange_cgrid(uc_i, vc_i, h, fill="y")
    return ucx_p[..., :, :N], vcy_p[..., :N, :]


def _c_sw_half_2d(state, m: "SWMetrics", dt2: float, hs,
                  up, vp, dpx, dpy):
    """FV3 ``c_sw`` role, SW form: a cheap C-grid half step.

    Advances the mass field by dt2 with 1st-order upwind fluxes and the
    C winds by dt2 with a forward-backward momentum update (absolute
    vorticity x tangential wind, cell KE + geopotential gradients, all
    orthogonal-approximation), producing time-centered ADVECTIVE winds
    for the full D stage.  Only the advecting C winds are
    time-centered -- the D-grid prognostics are updated once, from
    time-n fields, exactly FV3's c_sw/d_sw split -- which removes the
    full-cost provisional D step the round-2..4 midpoint scheme paid
    (measured 303 ms of the 1046 ms C192 step).
    """
    uc, vc, vc_on_x, uc_on_y = padded_cgrid_winds(
        state.u, state.v, m, up, vp
    )
    bc, ke, rarea_p, zf_u, zf_v, vbar_u, ubar_v = _c_half_winds_common(
        uc, vc, vc_on_x, uc_on_y, up, vp, m
    )
    # 1st-order upwind half-step mass update on the padded lattice
    # (interior + edge bands valid; corner blocks never consumed)
    fx = ppm_flux(dpx, uc, -1, 1) * (uc * dt2 * bc(m.dy_fs))
    fy = ppm_flux(dpy, vc, -2, 1) * (vc * dt2 * bc(m.dx_fs))
    div = (fx - _shx(fx, 1)) + (fy - _shy(fy, 1))
    delpc = dpx + div * rarea_p
    phi = GRAV * delpc
    if hs is not None:
        phi = phi + GRAV * halo_exchange(hs, m.halo, fill="x")
    kphi = ke + phi
    duc = dt2 * (
        zf_u * vbar_u
        - (kphi - _shx(kphi, -1)) / bc(m.dxc_f)
    )
    dvc = dt2 * (
        -zf_v * ubar_v
        - (kphi - _shy(kphi, -1)) / bc(m.dyc_f)
    )
    return _finish_c_half(uc, vc, duc, dvc, m)


def shallow_water_step(
    state: ShallowWaterState,
    m: SWMetrics,
    dt: float,
    hord: int = 5,
    d2_damp: float = 0.12,
    hs=None,
    midpoint: bool = True,
    c_half: bool = True,
):
    """One SW step.  Returns the new state.

    midpoint=True (default): time-centered advective winds.  With
    c_half=True (default) these come from the cheap C-grid half-stage
    (``_c_sw_half_2d``, FV3's c_sw role): only the advecting C winds
    are half-stepped, and the D-grid update runs once from the time-n
    state.  c_half=False keeps the legacy two-stage midpoint scheme (a
    full provisional half step with 1st-order reconstruction).  The
    plain forward-backward scheme (midpoint=False) is weakly unstable
    for the rotational modes (linearized growth ~1.0006-1.0036 per
    substep, measured by the jacfwd eigen-analysis in tests/test_sw.py);
    time-centering makes it neutral.

    hs: optional terrain height [6, n, n] (adds to the geopotential).
    """
    if midpoint and c_half:
        h = m.halo
        up, vp = halo_exchange_dgrid(state.u, state.v, h)
        dpx = halo_exchange(state.delp, h, fill="x")
        dpy = halo_exchange(state.delp, h, fill="y")
        adv = _c_sw_half_2d(state, m, 0.5 * dt, hs, up, vp, dpx, dpy)
        return _sw_core(
            state, state, m, dt, hord, d2_damp, hs,
            exch=(up, vp, dpx, dpy), adv=adv,
        )
    if midpoint:
        # damping is nondimensional (not dt-scaled): apply it once per
        # substep (stage 2, on base winds), not once per stage --
        # staging it compounds (I - d2 L)^2-like terms that break the
        # forward-Euler stability bound
        half = _sw_core(state, state, m, 0.5 * dt, 1, 0.0, hs)
        return _sw_core(half, state, m, dt, hord, d2_damp, hs)
    return _sw_core(state, state, m, dt, hord, d2_damp, hs)


def _sw_core(
    ev: ShallowWaterState,
    base: ShallowWaterState,
    m: SWMetrics,
    dt: float,
    hord: int,
    d2_damp: float,
    hs=None,
    exch=None,
    adv=None,
):
    """Flux-form update of `base` with all fluxes/gradients evaluated on
    `ev` (midpoint stage form; ev is base for forward-backward).

    exch: optional precomputed (up, vp, dpx, dpy) halo exchanges of ev
    (shared with the C half-stage).  adv: optional precomputed
    time-centered advective C winds (uc, vc) from the half-stage; when
    given the internal C-wind derivation from ev's D winds is skipped.
    """
    h, n = m.halo, m.n
    N = n + 2 * h
    delp, u, v = ev

    # --- halo exchanges ---------------------------------------------------
    if exch is not None:
        up, vp, dpx, dpy = exch
    else:
        up, vp = halo_exchange_dgrid(u, v, h)  # [6,N+1,N], [6,N,N+1]
        dpx = halo_exchange(delp, h, fill="x")
        dpy = halo_exchange(delp, h, fill="y")

    # --- C-face normal winds ----------------------------------------------
    # x-face (j, I) between cells (j, I-1), (j, I): average of the four
    # adjacent u edges (rows j, j+1; spans [I-1, I] and [I, I+1]).
    # Computed on each face's own face lattice (touching only edge halos)
    # and then distributed by the C-grid exchange so halo AND cube-corner
    # values are canonical -- the property that makes shared-edge mass
    # fluxes cancel exactly (FV3 likewise halo-updates uc/vc).
    if adv is not None:
        uc, vc = adv
    else:
        uc_A, vc_A = c_grid_winds(up, vp, m)
        uc_int = uc_A[:, h : h + n, h : h + n + 1]  # x-faces [6,n,n+1]
        vc_int = vc_A[:, h : h + n + 1, h : h + n]  # y-faces [6,n+1,n]
        uc_int, vc_int = canonicalize_cgrid_boundary(uc_int, vc_int)
        ucx_p, _ = halo_exchange_cgrid(uc_int, vc_int, h, fill="x")
        _, vcy_p = halo_exchange_cgrid(uc_int, vc_int, h, fill="y")
        uc = ucx_p[:, :, :N]  # face lattice embedded: [j, i] = face i
        vc = vcy_p[:, :N, :]

    crx = uc * dt / m.dxc_f
    cry = vc * dt / m.dyc_f
    xfx = uc * dt * m.dy_fs  # flux width = dy * sina
    yfx = vc * dt * m.dx_fs

    # --- mass transport ---------------------------------------------------
    fx, fy = fv_tp_2d(dpx, dpy, crx, cry, xfx, yfx, m.area_px, m.area_py,
                      hord)
    div = (fx - _shx(fx, 1)) + (fy - _shy(fy, 1))
    delp_new = base.delp + div[:, h : h + n, h : h + n] * m.rarea

    # --- absolute vorticity (cell-centered) -------------------------------
    # circulation around each interior cell uses only the face's own
    # edges; the scalar halo exchange then provides canonical halo and
    # cube-corner values (vorticity is a scalar, so this is exact)
    udx = u * m.dx_u[:, h : h + n + 1, h : h + n]
    vdy = v * m.dy_v[:, h : h + n, h : h + n + 1]
    vort = (
        udx[:, :-1, :] - udx[:, 1:, :] + vdy[:, :, 1:] - vdy[:, :, :-1]
    )
    zeta_int = vort * m.rarea  # [6, n, n]
    omega_x = halo_exchange(zeta_int, h, fill="x") + m.f_px
    omega_y = halo_exchange(zeta_int, h, fill="y") + m.f_py

    # vorticity fluxes with displacement "mass" fluxes (advective form)
    fxo, fyo = fv_tp_2d(
        omega_x, omega_y, crx, cry,
        uc * dt * m.sina_u, vc * dt * m.sina_v,
        m.area_px, m.area_py, hord,
    )

    # --- corner kinetic energy + geopotential (forward-backward) ---------
    # corner winds: average of the two edges meeting at the corner
    ub = 0.5 * (_shx(up, -1) + up)  # [6, N+1, N]: entry I ~ corner col I
    vb = 0.5 * (_shy(vp, -1) + vp)  # [6, N, N+1]
    ubp = jnp.pad(ub, ((0, 0), (0, 0), (0, 1)))
    vbp = jnp.pad(vb, ((0, 0), (0, 1), (0, 0)))
    # |V|^2 = (u1^2 + u2^2 - 2 cosa u1 u2) / sin^2 (covariant metric)
    ke_c = 0.5 * (
        ubp ** 2 + vbp ** 2 - 2.0 * m.cosa_b * ubp * vbp
    ) * m.rsin2_b  # [6, N+1, N+1]; last row/col padding never consumed

    # cube-corner vertices: three faces meet, so the B-grid stencil is
    # ill-defined and each face would compute a different value.  Use the
    # symmetric 3-edge form ke = (a^2+b^2+c^2)/3 from the three REAL
    # incident boundary-edge winds (the decomposition identity for three
    # ~120-degree unit tangents), which every face evaluates identically.
    hn = h + n
    vmasks = vertex_masks(m)
    for (cj, ci), es, vm in zip(
        ((h, h), (h, hn), (hn, h), (hn, hn)),
        (
            ((up, h, h), (vp, h, h), (vp, h - 1, h)),
            ((up, h, hn - 1), (vp, h, hn), (vp, h - 1, hn)),
            ((up, hn, h), (vp, hn - 1, h), (vp, hn, h)),
            ((up, hn, hn - 1), (vp, hn - 1, hn), (vp, hn, hn)),
        ),
        vmasks,
    ):
        a, b, c = (arr[:, j, i] for arr, j, i in es)
        ke_c = _masked_vertex_set(
            ke_c, (cj, ci), (a * a + b * b + c * c) / 3.0, vm
        )

    dp_new_p = halo_exchange(delp_new, h, fill="y")
    if hs is not None:
        dp_new_p = dp_new_p + halo_exchange(hs, h, fill="y")
    phi = GRAV * dp_new_p
    # corner average of the cell-centered geopotential
    phi_e = jnp.pad(phi, ((0, 0), (1, 1), (1, 1)), mode="edge")
    phi_c = 0.25 * (
        phi_e[:, :-1, :-1]
        + phi_e[:, :-1, 1:]
        + phi_e[:, 1:, :-1]
        + phi_e[:, 1:, 1:]
    )  # [6, N+1, N+1]
    # vertices: mean of the 3 real adjacent cells (the 4th slot is a
    # fill-dependent corner ghost that the faces would disagree on)
    for (cj, ci), cells, vm in zip(
        ((h, h), (h, hn), (hn, h), (hn, hn)),
        (
            ((h - 1, h), (h, h - 1), (h, h)),
            ((h - 1, hn - 1), (h, hn), (h, hn - 1)),
            ((hn, h), (hn - 1, h), (hn - 1, h - 1)),
            ((hn, hn - 1), (hn - 1, hn), (hn - 1, hn - 1)),
        ),
        vmasks,
    ):
        vals = sum(phi[:, j, i] for j, i in cells) / 3.0
        phi_c = _masked_vertex_set(phi_c, (cj, ci), vals, vm)
    kphi = ke_c + phi_c

    # --- dissipation on the BASE winds (once per substep: the midpoint
    # half-stage passes d2_damp=0, which disables ALL dissipation --
    # applying the non-dt-scaled dampers per stage would both double
    # their strength and double the compile graph) -------------------------
    if d2_damp != 0.0:
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
    du_grad = -(dt / m.dx_u) * (kphi[:, :, 1:] - kphi[:, :, :-1])
    dv_grad = -(dt / m.dy_v) * (kphi[:, 1:, :] - kphi[:, :-1, :])
    # fyo lives on y-faces == u positions (fyo[:, j, i] at u[j, i]);
    # fxo on x-faces == v positions
    fyo_u = jnp.pad(fyo, ((0, 0), (0, 1), (0, 0)))
    fxo_v = jnp.pad(fxo, ((0, 0), (0, 0), (0, 1)))
    du_p = fyo_u + du_grad
    dv_p = -fxo_v + dv_grad

    u_new = base.u + du_p[:, h : h + n + 1, h : h + n] + du_damp
    v_new = base.v + dv_p[:, h : h + n, h : h + n + 1] + dv_damp
    # shared boundary D-edges are stored once per adjacent face; their
    # independent updates drift at the coordinate kink -- re-impose
    # single-valuedness (mpp domain-symmetry role)
    u_new, v_new = average_dgrid_boundary(u_new, v_new)
    # conservative dissipative 2-delta filter on the mass field: kills
    # the weakly growing boundary-ring mass modes (see scalar_filter);
    # skipped in the half stage along with the other dissipation
    if d2_damp != 0.0:
        delp_new = scalar_filter(delp_new, m, FILTER_COEF)
    return ShallowWaterState(delp_new, u_new, v_new)


def make_sw_stepper(g: CubedSphereGrid, dt: float, hord: int = 5,
                    d2_damp: float = 0.12, dtype=jnp.float32, **scheme):
    """Build a jitted multi-substep SW stepper."""
    m = SWMetrics.make(g, dtype, **scheme)

    @partial(jax.jit, static_argnames=("nsteps",))
    def run(state: ShallowWaterState, nsteps: int):
        def body(s, _):
            return shallow_water_step(s, m, dt, hord, d2_damp), None

        out, _ = jax.lax.scan(body, state, None, length=nsteps)
        return out

    return run, m


def combined_wind_damping(u, v, m, d2, cv, cc):
    """div_damp + vort_damp + corner_div_damp with SHARED exchanges.

    All three dampers are -c * A^T(W A u) forms whose A starts with the
    same D-grid halo exchange; computed separately they cost 4 forward
    + 4 transposed exchange chains per substep (vort's del-4 form needs
    two).  This fuses them into one forward F = (mass_div, circulation,
    corner_div) + one combined vjp (linearity lets the three cotangents
    share the transpose), plus the one extra V / V^T pair the del-4
    vorticity damper needs: 2+2 chains total, bit-equivalent math up to
    summation order.  Works unchanged under within-face tiling (the vjp
    routes cotangents through the ppermute/table transposes).
    """
    if d2 == 0.0 and cv == 0.0 and cc == 0.0:
        return jnp.zeros_like(u), jnp.zeros_like(v)
    h, n = m.halo, m.n
    lead = u.ndim - 3

    def circ_from_padded(up, vp):
        z = (
            up[..., :-1, :] - up[..., 1:, :]
            + vp[..., :, 1:] - vp[..., :, :-1]
        )
        return z[..., h : h + n, h : h + n]

    def F(uu, vv):
        up, vp = halo_exchange_dgrid(uu, vv, h)
        return (
            _mass_div_from_padded(up, vp, m),
            circ_from_padded(up, vp),
            _div_b_from_padded(up, vp, m),
        )

    (div, z, db), vjp = jax.vjp(F, u, v)

    # del-4 vorticity: one extra V^T / V pair on the intermediate
    def V(uu, vv):
        up, vp = halo_exchange_dgrid(uu, vv, h)
        return circ_from_padded(up, vp)

    du1, dv1 = jax.vjp(V, u, v)[1](z)
    z2 = V(du1, dv1)

    area = (1.0 / m.rarea).reshape(
        m.rarea.shape[:1] + (1,) * lead + m.rarea.shape[1:]
    )
    if m.inv_corner_mult is not None:
        im = m.inv_corner_mult
        inv_mult = im.reshape(
            im.shape[:1] + (1,) * lead + im.shape[1:]
        ).astype(u.dtype)
    else:
        inv_mult = jnp.asarray(
            1.0 / _corner_multiplicity(m.n), u.dtype
        )
    du, dv = vjp((
        (-d2 * m.divdamp_scale) * div * area,
        (-cv / 8.0) * z2,
        (-cc) * db * inv_mult,
    ))
    return du, dv
