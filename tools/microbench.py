"""Microbenchmark the dycore substep's building blocks on the GPU.

Times each primitive standalone at the given resolutions; every window
ends in block_until_ready.  Identifies which component breaks the
C48->C192 scaling.

    python tools/microbench.py 48 192
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, iters=10, label=""):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def main(ns):
    from fv3net_tpu.grid import CubedSphereGrid
    from fv3net_tpu.grid.halo import (
        _halo_exchange_gather,
        halo_exchange,
        halo_exchange_dgrid,
    )
    from fv3net_tpu.dycore.sw import SWMetrics, div_damp, scalar_filter
    from fv3net_tpu.ops.advection import fv_tp_2d
    from fv3net_tpu.ops.remap import ppm_remap

    nz, h = 63, 3
    dev = jax.devices()[0]
    for n in ns:
        print(f"=== C{n} x {nz} ===", flush=True)
        g = CubedSphereGrid.make(n, halo=h)
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            m = SWMetrics.make(g, jnp.float32)
        import dataclasses as dc

        m = dc.replace(
            m,
            **{
                f.name: jax.device_put(getattr(m, f.name), dev)
                for f in dc.fields(m)
                if isinstance(getattr(m, f.name), jax.Array)
            },
        )
        N = n + 2 * h
        rng = np.random.RandomState(0)
        with jax.default_device(cpu):
            q = jnp.asarray(
                rng.randn(6, nz, n, n).astype(np.float32)
            )
            u = jnp.asarray(
                rng.randn(6, nz, n + 1, n).astype(np.float32)
            )
            v = jnp.asarray(
                rng.randn(6, nz, n, n + 1).astype(np.float32)
            )
            qp = jnp.asarray(
                rng.randn(6, nz, N, N).astype(np.float32)
            )
            cr = jnp.asarray(
                (0.1 * rng.randn(6, nz, N, N)).astype(np.float32)
            )
        q, u, v, qp, cr = (
            jax.device_put(a, dev) for a in (q, u, v, qp, cr)
        )
        field_mb = q.size * 4 / 1e6
        pad_mb = qp.size * 4 / 1e6

        ex_y = jax.jit(lambda a: halo_exchange(a, h, fill="y"))
        t = timeit(ex_y, q)
        print(
            f"halo_exchange fill=y          {t:8.2f} ms"
            f"  ({2 * field_mb / t:6.1f} GB/s eff)",
            flush=True,
        )
        exg = jax.jit(lambda a: _halo_exchange_gather(a, h, "y"))
        t = timeit(exg, q)
        print(f"halo_exchange strip-gather    {t:8.2f} ms", flush=True)
        exd = jax.jit(lambda a, b: halo_exchange_dgrid(a, b, h))
        t = timeit(exd, u, v)
        print(f"halo_exchange_dgrid           {t:8.2f} ms", flush=True)
        # batched scalar exchange: 4 fields at once
        q4 = jnp.stack([q, q, q, q], axis=0)
        ex4 = jax.jit(lambda a: _halo_exchange_gather(a, h, "y"))
        # _halo_exchange_gather expects [6,...]; move stack inside
        ex4 = jax.jit(
            lambda a: _halo_exchange_gather(
                jnp.moveaxis(a, 0, 1).reshape(6, 4 * nz, n, n), h, "y"
            )
        )
        t = timeit(ex4, q4)
        print(f"halo_exchange 4-stacked       {t:8.2f} ms", flush=True)

        tp = jax.jit(
            lambda qpx, qpy, crx, cry: fv_tp_2d(
                qpx, qpy, crx, cry, crx, cry,
                m.area_px[:, None], m.area_py[:, None], 5,
            )
        )
        t = timeit(tp, qp, qp, cr, cr)
        print(f"fv_tp_2d (hord=5)             {t:8.2f} ms", flush=True)

        sf = jax.jit(lambda a: scalar_filter(a, m, 0.1))
        t = timeit(sf, q)
        print(f"scalar_filter                 {t:8.2f} ms", flush=True)

        dd = jax.jit(lambda a, b: div_damp(a, b, m, 0.12))
        t = timeit(dd, u, v)
        print(f"div_damp (vjp)                {t:8.2f} ms", flush=True)

        from fv3net_tpu.dycore.sw import (
            CORNER_DAMP_COEF,
            VORT_DAMP_COEF,
            corner_div_damp,
            vort_damp,
        )

        vd = jax.jit(lambda a, b: vort_damp(a, b, m, VORT_DAMP_COEF))
        t = timeit(vd, u, v)
        print(f"vort_damp                     {t:8.2f} ms", flush=True)
        cd = jax.jit(
            lambda a, b: corner_div_damp(a, b, m, CORNER_DAMP_COEF)
        )
        t = timeit(cd, u, v)
        print(f"corner_div_damp               {t:8.2f} ms", flush=True)

        def trio(a, b):
            du, dv = div_damp(a, b, m, 0.12)
            du2, dv2 = vort_damp(a, b, m, VORT_DAMP_COEF)
            du3, dv3 = corner_div_damp(a, b, m, CORNER_DAMP_COEF)
            return du + du2 + du3, dv + dv2 + dv3

        t = timeit(jax.jit(trio), u, v)
        print(f"damper trio (one jit)         {t:8.2f} ms", flush=True)

        # full remap_step (7 field remaps incl. staggered winds)
        from fv3net_tpu.dycore.hydro import (
            DycoreState,
            add_nonhydrostatic_fields,
            hybrid_coefficients,
            remap_step,
        )

        ak, bk = hybrid_coefficients(nz, 300.0)
        with jax.default_device(cpu):
            dp0 = jnp.broadcast_to(
                (ak[1:] - ak[:-1] + (bk[1:] - bk[:-1]) * 1e5)[
                    None, :, None, None
                ],
                (6, nz, n, n),
            ).astype(jnp.float32)
            pt0 = jnp.full((6, nz, n, n), 300.0, jnp.float32)
            st0 = DycoreState(
                dp0, pt0,
                jnp.zeros((6, nz, n + 1, n), jnp.float32),
                jnp.zeros((6, nz, n, n + 1), jnp.float32),
                jnp.zeros((2, 6, nz, n, n), jnp.float32),
            )
            st0 = add_nonhydrostatic_fields(st0, 300.0)
        st0 = jax.device_put(st0, dev)
        akd = jax.device_put(ak.astype(jnp.float32), dev)
        bkd = jax.device_put(bk.astype(jnp.float32), dev)
        rs = jax.jit(
            lambda s: remap_step(s, akd, bkd, 300.0, 9, 9, 9, 9)
        )
        t = timeit(rs, st0)
        print(f"remap_step (all fields)       {t:8.2f} ms", flush=True)

        # sim1: jnp scans vs the Triton kernel (in-one-jit each)
        from fv3net_tpu.dycore.riemann import (
            layer_mean_pressure,
            sim1_solver,
        )
        from fv3net_tpu.ops.pallas_sim1 import sim1_solver_pallas
        from fv3net_tpu.constants import GRAV

        with jax.default_device(cpu):
            pe0 = 300.0 + jnp.concatenate(
                [jnp.zeros_like(dp0[:, :1]),
                 jnp.cumsum(dp0, axis=1)], axis=1
            )
            pm0 = layer_mean_pressure(dp0, pe0)
            ws0 = jnp.zeros((6, n, n), jnp.float32)
        pe0, pm0, ws0 = (
            jax.device_put(a, dev) for a in (pe0, pm0, ws0)
        )
        dm0 = st0.delp / GRAV
        s1j = jax.jit(
            lambda: sim1_solver(
                150.0, dm0, st0.pt, st0.delz, st0.w, pe0, pm0, ws0
            )
        )
        t = timeit(s1j)
        print(f"sim1 jnp                      {t:8.2f} ms", flush=True)
        t = timeit(
            lambda: sim1_solver_pallas(
                150.0, dm0, st0.pt, st0.delz, st0.w, pe0, pm0, ws0
            )
        )
        print(f"sim1 triton kernel            {t:8.2f} ms", flush=True)

        # vertical remap: [nz, 6, n, n] layout as used in remap_step
        with jax.default_device(cpu):
            dp = jnp.asarray(
                (100.0 + rng.rand(6, nz, n, n)).astype(np.float32)
            )
        dp = jax.device_put(dp, dev)

        def rm(pt, delp):
            pe1 = 300.0 + jnp.concatenate(
                [jnp.zeros_like(delp[:, :1]),
                 jnp.cumsum(delp, axis=1)], axis=1
            )
            pe2 = pe1[:, :1] + (
                pe1[:, -1:] - pe1[:, :1]
            ) * jnp.linspace(0, 1, nz + 1)[None, :, None, None]
            return jnp.moveaxis(
                ppm_remap(
                    jnp.moveaxis(pt, 1, 0), jnp.moveaxis(pe1, 1, 0),
                    jnp.moveaxis(pe2, 1, 0), iv=1, kord=9,
                    exact_boundaries=True,
                ),
                0, 1,
            )

        t = timeit(jax.jit(rm), q, dp)
        print(f"ppm_remap (kord=9)            {t:8.2f} ms", flush=True)

        # raw copy for reference bandwidth
        cp = jax.jit(lambda a: a * 1.000001 + 0.000001)
        t = timeit(cp, qp)
        print(
            f"elementwise copy (padded)     {t:8.2f} ms"
            f"  ({2 * pad_mb / t:6.1f} GB/s)",
            flush=True,
        )


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [48, 192])
