"""The fused SIM1 vertical-solver kernel (ops/pallas_sim1.py, Triton
route) against the jnp reference in interpret mode; the jnp reference
against an independent float64 numpy oracle; the plain column-pressure
chain against numpy; and the per-platform choice of kernel."""

import ast
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fv3net_tpu.constants import (
    CP_AIR,
    CV_AIR,
    GRAV,
    KAPPA,
    RDGAS,
    REFERENCE_SURFACE_PRESSURE as P00,
)
from fv3net_tpu.dycore.hydro import column_pressures
from fv3net_tpu.dycore.riemann import (
    hydrostatic_dz,
    layer_mean_pressure,
    sim1_solve,
    sim1_solver,
)
from fv3net_tpu.ops.pallas_sim1 import sim1_solver_pallas

DT = 150.0
REPO = pathlib.Path(__file__).resolve().parents[1]


def _sim1_args(n=8, nz=13, dtype=np.float32, seed=0):
    """Physically plausible columns (the solver's gas law needs
    dz < 0, dm > 0, pt > 0)."""
    rng = np.random.RandomState(seed)
    ps, ptop = 1.0e5, 300.0
    pe1d = np.linspace(ptop, ps, nz + 1)
    pe = np.broadcast_to(
        pe1d[:, None, None], (nz + 1, n, n)
    ) * (1.0 + 0.01 * rng.rand(6, nz + 1, n, n))
    pe = np.sort(pe, axis=1)
    delp = pe[:, 1:] - pe[:, :-1]
    pt = 300.0 + 30.0 * rng.randn(6, nz, n, n)
    pt = np.clip(pt, 200.0, 400.0)
    dm = delp / GRAV
    pm = np.asarray(
        layer_mean_pressure(jnp.asarray(delp), jnp.asarray(pe))
    )
    dz = np.asarray(
        hydrostatic_dz(
            jnp.asarray(delp), jnp.asarray(pt), jnp.asarray(pe)
        )
    ) * (1.0 + 0.05 * rng.randn(6, nz, n, n))
    w = 2.0 * rng.randn(6, nz, n, n)
    ws = 0.5 * rng.randn(6, n, n)
    c = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    return (
        c(dm), c(pt), c(dz), c(w), c(pe), c(pm), c(ws)
    )


def _assert_sim1_close(got, ref, rtol):
    for name, g, r in zip(("w2", "dz2", "ppe"), got, ref):
        g, r = np.asarray(g), np.asarray(r)
        np.testing.assert_allclose(
            g, r, rtol=rtol, atol=rtol * np.abs(r).max(), err_msg=name
        )


# interpret mode runs the kernel's own arithmetic in the reference's
# order except the ppe prefix sum (sequential vs XLA's cumsum), so f32
# agrees to a few ulp of the column's largest value and f64 to ~1e-13
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
# 64 columns: one full block; 49: one ragged block; 144: two full and a
# ragged one (the kernel takes 64 columns per program)
@pytest.mark.parametrize("n", [8, 7, 12])
@pytest.mark.parametrize("nz", [8, 63])
def test_sim1_kernel_matches_jnp(nz, n, dtype):
    args = _sim1_args(n=n, nz=nz, dtype=dtype, seed=nz + n)
    ref = sim1_solver(DT, *args)
    got = sim1_solver_pallas(DT, *args, interpret=True)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
    _assert_sim1_close(
        got, ref, rtol=5e-5 if dtype == np.float32 else 1e-12
    )


def _np_sim1_column(dm, pt, dz, w, pem, pm, ws, dt, p_fac=0.05):
    """One column of the solver in float64 numpy: the provisional
    interface perturbation as its lower-bidiagonal system and the
    implicit w as its tridiagonal system, each solved densely."""
    gamma = CP_AIR / CV_AIR
    nz = dm.size
    pe = P00 * (-dm * RDGAS * pt / dz / P00) ** gamma - pm
    g = dm[:-1] / dm[1:]
    bb = np.append(2.0 * (1.0 + g), 2.0)
    dd = np.append(3.0 * (pe[:-1] + g * pe[1:]), 3.0 * pe[-1])
    # row k: pp_k + bet_k pp_{k+1} = dd_k, pp_0 = 0
    bet = np.empty(nz)
    bet[0] = bb[0]
    for k in range(1, nz):
        bet[k] = bb[k] - g[k - 1] / bet[k - 1]
    lower = np.diag(bet) + np.diag(np.ones(nz - 1), -1)
    pp = np.concatenate([[0.0], np.linalg.solve(lower, dd)])
    t1g = 2.0 * gamma * dt * dt
    aa = t1g / (dz[:-1] + dz[1:]) * (pem[1:-1] + pp[1:-1])
    p1 = t1g / dz[-1] * (pem[-1] + pp[-1])
    a_up = np.append(0.0, aa)
    a_dn = np.append(aa, p1)
    rhs = dm * w + dt * (pp[1:] - pp[:-1])
    rhs[-1] -= p1 * ws
    tri = (
        np.diag(dm - a_up - a_dn)
        + np.diag(a_up[1:], -1)
        + np.diag(a_dn[:-1], 1)
    )
    w2 = np.linalg.solve(tri, rhs)
    ppe = np.concatenate([[0.0], np.cumsum(dm * (w2 - w) / dt)])
    p_lay = np.maximum(pm + (ppe[:-1] + 2.0 * ppe[1:]) / 3.0, p_fac * pm)
    dz2 = -(dm * RDGAS * pt / P00) * (p_lay / P00) ** (-CV_AIR / CP_AIR)
    return w2, dz2, ppe


@pytest.mark.parametrize("nz,n", [(8, 3), (13, 4), (63, 2)])
def test_sim1_solver_matches_numpy_oracle(nz, n):
    args = _sim1_args(n=n, nz=nz, dtype=np.float64, seed=nz)
    got = [np.asarray(a) for a in sim1_solver(DT, *args)]
    a = [np.asarray(x) for x in args]
    ref = [np.empty_like(x) for x in got]
    for f in range(6):
        for j in range(n):
            for i in range(n):
                col = _np_sim1_column(
                    *(x[f, :, j, i] for x in a[:6]), a[6][f, j, i], DT
                )
                for r, c in zip(ref, col):
                    r[f, :, j, i] = c
    _assert_sim1_close(got, ref, rtol=1e-9)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 2e-5)])
@pytest.mark.parametrize("nz", [5, 63])
def test_column_pressures_match_numpy(nz, dtype, rtol):
    rng = np.random.RandomState(nz)
    ptop = 300.0
    dp = 900.0 + 200.0 * rng.rand(2, nz, 4, 5)
    pe, pik, pi_lay = column_pressures(jnp.asarray(dp, dtype), ptop)
    pe_ref = ptop + np.concatenate(
        [np.zeros_like(dp[:, :1]), np.cumsum(dp, axis=1)], axis=1
    )
    pik_ref = (pe_ref / P00) ** KAPPA
    pi_ref = (
        pik_ref[:, 1:] * pe_ref[:, 1:] - pik_ref[:, :-1] * pe_ref[:, :-1]
    ) / ((1.0 + KAPPA) * dp)
    for got, ref in ((pe, pe_ref), (pik, pik_ref), (pi_lay, pi_ref)):
        assert got.dtype == dtype
        np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol)


def test_column_pressures_finite_on_empty_columns():
    """Unused halo-corner columns can carry non-positive pressures;
    the Exner power of the floored pressure keeps them finite."""
    dp = jnp.zeros((1, 4, 2, 2)).at[0, :, 0, 0].set(-100.0)
    pe, pik, pi_lay = column_pressures(dp, 0.0)
    assert np.isfinite(np.asarray(pik)).all()
    assert float(pe[0, -1, 0, 0]) == -400.0


def _lowered_sim1(platform):
    args = _sim1_args(n=4, nz=8)
    return (
        jax.jit(lambda *a: sim1_solve(DT, *a))
        .trace(*args)
        .lower(lowering_platforms=(platform,))
        .as_text()
    )


@pytest.mark.parametrize("platform,kernel", [("cuda", True),
                                             ("cpu", False)])
def test_sim1_dispatch_per_platform(platform, kernel):
    """CUDA lowerings carry the Triton kernel, the others the scans."""
    txt = _lowered_sim1(platform)
    assert ("__gpu$xla.gpu.triton" in txt) == kernel
    assert ("stablehlo.while" in txt) != kernel


GPU_ROUTES = {"triton", "mosaic_gpu"}


def _pallas_backends(path):
    """Pallas backend modules a source file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module == "jax.experimental.pallas":
                out |= {a.name for a in node.names} - {"pallas"}
            elif node.module.startswith("jax.experimental.pallas."):
                out.add(node.module.split(".")[3])
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("jax.experimental.pallas."):
                    out.add(a.name.split(".")[3])
    return out


@pytest.mark.parametrize("root", ["fv3net_tpu", "tools", "."])
def test_pallas_imports_are_gpu_routes(root):
    """No module of the package, the tools or the repo root imports a
    Pallas backend other than the GPU routes."""
    base = REPO / root
    files = base.rglob("*.py") if root != "." else base.glob("*.py")
    found = {str(p.relative_to(REPO)): _pallas_backends(p) for p in files}
    assert found
    bad = {p: b - GPU_ROUTES for p, b in found.items() if b - GPU_ROUTES}
    assert not bad
