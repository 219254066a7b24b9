"""Smoke run of the main path on one NVIDIA GPU.

    python chip_smoke.py               # phases device .. coupled_c48
    python chip_smoke.py --four-cards  # tiled SPMD C48 step on 4 cards

Phases (one card): `device` (a GPU, or fail), `dycore_c48` (the
nonhydrostatic C48 x 63 step as bench.py builds it, checked for
finiteness, dry-mass conservation and against the same step on the
host CPU), `dycore_c192` (C192 x 63, the same checks but the CPU
comparison), `kernels` (every hand-written GPU kernel against its plain
jnp reference, with both times) and `coupled_c48` (the compiled coupled
step against the eager TimeLoop).  Any failing check raises, so the
script exits non-zero and prints no result.  The last stdout line is
one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# XLA's GPU autotuner triples the compile time of the dycore step (C48:
# 187 s with it, 58 s without, H100 80GB HBM3 at 400 W); the smoke run
# compiles five such programs inside its time limit.
AUTOTUNE_FLAG = "--xla_gpu_autotune_level=0"

# Two float32 programs of the same step round differently wherever XLA
# fuses them differently (another fusion boundary, an FMA where there
# was none), and the winds, which start from rest, come from a near-
# cancellation of large pressure-gradient terms, so relative to their
# own size they move by ~1e5 float32 epsilons: one C48x63 step on an
# H100 80GB HBM3 (700 W) differed from the same step on the host CPU by
# 7.1e-6 in delp, 4.6e-6 in pt and 5.9e-3 in u (max|diff| / max|field|),
# and the tiled four-card step from the one-card step by 7.1e-6, 4.8e-6
# and 4.4e-3; float32 against float64 on the CPU at C12-C24 gives ~5e-6
# for delp, ~3e-3 for u, v and up to ~2e-2 for w.  On the CPU the tiled
# and the face-level float32 programs round alike and agree to ~5e-7.
# An error in the step itself is O(1).
#
# Checks against float64: the step under test and a reference float32
# step (the CPU's for the one-card phase, the one-card step for the four
# cards) are both measured against a CPU float64 step from the same
# state; per field,
# max|tested - f64| <= CPU_ERR_FACTOR * max|ref32 - f64| + 1e-6 * max|f64|,
# i.e. within an order of magnitude of float32's own rounding error.
CPU_ERR_FACTOR = 10.0
# compiled coupled step vs the eager loop after one step: max|diff| /
# max|field| per field, mass and heat fields an order of magnitude
# above the differences seen, winds and tracers (physics switches at
# saturation flip single cells) looser
STEP_TOL = {"delp": 1e-4, "pt": 1e-4, "delz": 1e-4,
            "u": 5e-2, "v": 5e-2, "w": 5e-2, "q": 5e-2}
# relative change of the global dry mass sum(delp * area) over the
# phase's steps: float32 flux-form transport and a column-mass-exact
# remap conserve it to accumulated rounding
MASS_TOL = 2e-6
# kernel vs its jnp reference: float32, the same arithmetic in another
# order (sequential vs tree sums, fused multiply-adds)
KERNEL_TOL = 5e-5


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check_device(devices):
    """The first device must be a GPU; there is no CPU fallback."""
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found platform {d.platform!r} ({d.device_kind})"
        )
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def _max_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _fields(state):
    return {k: v for k, v in state._asdict().items() if v is not None}


def _dry_mass(delp, area):
    return float(np.sum(np.asarray(delp, np.float64) * area[:, None]))


def dycore_phase(phase, n, nz, dt_atmos, steps, cpu_device=None,
                 card=""):
    """The C<n> x nz nonhydrostatic step as bench.py builds it."""
    import jax
    import jax.numpy as jnp

    from bench import build_config

    t0 = time.perf_counter()
    run, state, phis = build_config(n, nz, jax, jnp, dt_atmos=dt_atmos)
    from fv3net_tpu.grid import CubedSphereGrid

    g = CubedSphereGrid.make(n, halo=3)
    area = g.area[:, 3:3 + n, 3:3 + n]
    dev = jax.local_devices()[0]
    host0 = jax.tree_util.tree_map(np.asarray, state)
    state = jax.device_put(state, dev)
    phis = jax.device_put(jnp.asarray(phis), dev)
    log(phase, f"build {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    compiled = run.lower(state, phis, 1).compile()
    log(phase, f"compile {time.perf_counter() - t0:.1f} s (set-up)")
    mem = compiled.memory_analysis()
    if mem is not None:
        log(phase, f"memory_analysis: {mem}")

    times = []
    out = state
    first = None
    for i in range(steps):
        t0 = time.perf_counter()
        out = compiled(out, phis)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
        if i == 0:
            first = jax.tree_util.tree_map(np.asarray, out)
    log(phase, "step times ms: " + ", ".join(
        f"{t * 1e3:.2f}" for t in times) + f" ({card})")

    final = jax.tree_util.tree_map(np.asarray, out)
    for k, v in _fields(final).items():
        if not np.isfinite(v).all():
            raise RuntimeError(f"{phase}: {k} not finite")
    m0 = _dry_mass(host0.delp, area)
    m1 = _dry_mass(final.delp, area)
    drift = abs(m1 - m0) / m0
    log(phase, f"dry mass drift {drift:.3e} over {steps} steps "
               f"(tolerance {MASS_TOL:.0e})")
    if drift > MASS_TOL:
        raise RuntimeError(f"{phase}: dry mass drift {drift:.3e}")

    result = {"step_ms": [t * 1e3 for t in times], "mass_drift": drift}
    if cpu_device is not None:
        t0 = time.perf_counter()
        cpu32, cpu64 = cpu_reference_steps(
            host0, phis, n, nz, dt_atmos, cpu_device,
            (np.float32, np.float64),
        )
        log(phase, f"CPU float32 and float64 steps "
                   f"{time.perf_counter() - t0:.1f} s (set-up)")
        check_against_f64(phase, "gpu", first, "cpu f32", cpu32, cpu64)
    return result


def check_against_f64(phase, name, tested, ref_name, ref32, truth):
    """Per field, `tested` may be off the float64 `truth` by at most
    CPU_ERR_FACTOR times the reference float32 step's own error."""
    errs = {}
    for k, v in _fields(tested).items():
        t = getattr(truth, k)
        e = errs[k] = _max_rel(v, t)
        e_ref = _max_rel(getattr(ref32, k), t)
        tol = CPU_ERR_FACTOR * e_ref + 1e-6
        log(phase, f"{k}: max|{name} - cpu f64|/max {e:.2e}, "
                   f"max|{ref_name} - cpu f64|/max {e_ref:.2e} "
                   f"(tolerance {tol:.2e})")
        if not e <= tol:
            raise RuntimeError(f"{phase}: {k} off the float64 reference")
    return errs


def cpu_reference_steps(host0, phis, n, nz, dt_atmos, cpu, dtypes,
                        n_split=6):
    """One step of the same configuration on the host CPU per dtype,
    from the host copy of the initial state."""
    import jax
    import jax.numpy as jnp

    from fv3net_tpu.dycore.hydro import make_dycore_stepper
    from fv3net_tpu.grid import CubedSphereGrid

    g = CubedSphereGrid.make(n, halo=3)
    out = []
    for dtype in dtypes:
        with jax.enable_x64(dtype == np.float64), jax.default_device(cpu):
            run, _, _ = make_dycore_stepper(
                g, nz, dt_atmos=dt_atmos, k_split=1, n_split=n_split,
                hord=5, dtype=dtype,
            )
            st = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, dtype), host0
            )
            ref = run(st, jnp.asarray(np.asarray(phis), dtype), 1)
            out.append(jax.tree_util.tree_map(np.asarray, ref))
    return out


def sim1_columns(n, nz, seed=0):
    """Solver inputs from the dycore's own rest state plus noise."""
    import jax.numpy as jnp

    from __graft_entry__ import _rest_state
    from fv3net_tpu.constants import GRAV
    from fv3net_tpu.dycore.hydro import column_pressures
    from fv3net_tpu.dycore.riemann import (
        hydrostatic_dz,
        layer_mean_pressure,
    )
    from fv3net_tpu.grid import CubedSphereGrid

    rng = np.random.RandomState(seed)
    st = _rest_state(CubedSphereGrid.make(n, halo=3), nz, 300.0,
                     jnp.float32)
    delp = jnp.asarray(st.delp)
    pt = jnp.asarray(
        st.pt + rng.randn(*st.pt.shape).astype(np.float32)
    )
    pe, _, _ = column_pressures(delp, 300.0)
    dz = hydrostatic_dz(delp, pt, pe) * jnp.asarray(
        1.0 + 0.01 * rng.randn(*st.pt.shape), jnp.float32
    )
    w = jnp.asarray(rng.randn(*st.pt.shape), jnp.float32)
    ws = jnp.asarray(0.1 * rng.randn(6, n, n), jnp.float32)
    return (delp / GRAV, pt, dz, w, pe, layer_mean_pressure(delp, pe),
            ws)


def _time(fn, args, iters=20):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def kernels_phase(sizes, nz=63, dt=150.0, interpret=False, card=""):
    """Each hand-written GPU kernel against its plain jnp reference."""
    import jax

    from fv3net_tpu.dycore.riemann import sim1_solver
    from fv3net_tpu.ops.pallas_sim1 import sim1_solver_pallas

    kern = jax.jit(lambda *a: sim1_solver_pallas(
        dt, *a, interpret=interpret))
    ref = jax.jit(lambda *a: sim1_solver(dt, *a))
    out = {}
    with jax.default_matmul_precision("highest"):
        for n in sizes:
            args = jax.device_put(sim1_columns(n, nz),
                                  jax.local_devices()[0])
            got, want = kern(*args), ref(*args)
            for name, a, b in zip(("w2", "dz2", "ppe"), got, want):
                err = _max_rel(a, b)
                log("kernels", f"sim1 C{n}x{nz} {name}: "
                               f"max|diff|/max|ref| {err:.2e} "
                               f"(tolerance {KERNEL_TOL:.0e})")
                if not (err <= KERNEL_TOL):
                    raise RuntimeError(f"sim1 C{n} {name} mismatch")
            tk, tr = _time(kern, args), _time(ref, args)
            log("kernels", f"sim1 C{n}x{nz}: triton kernel "
                           f"{tk * 1e3:.3f} ms, jnp scans "
                           f"{tr * 1e3:.3f} ms ({card})")
            out[f"sim1_c{n}"] = {"kernel_ms": tk * 1e3,
                                 "jnp_ms": tr * 1e3}
    return out


def _coupled_init(n, nz, dt):
    from fv3net_tpu import wrapper

    wrapper.initialize(
        wrapper.ModelConfig(
            npx=n + 1, npz=nz, physics_suite="gfs", do_radiation=True,
            hydrostatic=False, dt_atmos=dt,
        )
    )
    return wrapper


def coupled_phase(n, nz, steps, dt=900.0, card=""):
    """The compiled coupled step as bench.py builds it, against one
    step of the eager TimeLoop from the same initial condition."""
    import jax

    from bench import dense_ml_model
    from fv3net_tpu.runtime.compiled_loop import CompiledTimeLoop
    from fv3net_tpu.runtime.derived_state import DerivedModelState
    from fv3net_tpu.runtime.loop import TimeLoop
    from fv3net_tpu.runtime.steppers import PureMLStepper

    phase = f"coupled_c{n}"
    with jax.default_matmul_precision("highest"):
        model = dense_ml_model(nz)
        wrapper = _coupled_init(n, nz, dt)
        try:
            loop = TimeLoop(
                wrapper, DerivedModelState(wrapper), dt=dt,
                postphysics_stepper=PureMLStepper(
                    model, dt=dt, hydrostatic=False
                ),
                n_steps=1,
            )
            for _ in loop:
                pass
            eager = jax.tree_util.tree_map(
                np.asarray, wrapper.get_model().state
            )
        finally:
            wrapper.cleanup()

        wrapper = _coupled_init(n, nz, dt)
        try:
            t0 = time.perf_counter()
            cloop = CompiledTimeLoop(wrapper, ml_model=model)
            times = []
            for i in range(steps):
                t0 = t0 if i == 0 else time.perf_counter()
                cloop.step()
                cloop.block()
                times.append(time.perf_counter() - t0)
                if i == 0:
                    comp = jax.tree_util.tree_map(
                        np.asarray, cloop.mdl.state
                    )
            final = jax.tree_util.tree_map(np.asarray, cloop.mdl.state)
        finally:
            wrapper.cleanup()
    log(phase, f"compile + first step {times[0]:.1f} s "
                       f"(set-up); step times ms: " + ", ".join(
                           f"{t * 1e3:.2f}" for t in times[1:])
        + f" ({card})")
    for k, v in _fields(final).items():
        if not np.isfinite(v).all():
            raise RuntimeError(f"coupled: {k} not finite")
    for k, v in _fields(comp).items():
        err = _max_rel(v, getattr(eager, k))
        log(phase, f"compiled vs eager {k}: max|diff|/max|eager| "
                   f"{err:.2e} (tolerance {STEP_TOL[k]:.0e})")
        if err > STEP_TOL[k]:
            raise RuntimeError(f"coupled: {k} differs from eager loop")
    return {"step_ms": [t * 1e3 for t in times[1:]]}


def four_card_phase(n, nz, devices, dt_atmos=900.0, n_split=6, steps=3,
                    cpu_device=None, card=""):
    """The tiled SPMD step on a (1, 2, 2) mesh against one card, and
    both against a CPU float64 step when `cpu_device` is given."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from bench import build_config
    from fv3net_tpu.grid import CubedSphereGrid
    from fv3net_tpu.parallel.spmd_dycore import (
        make_tiled_spmd_dycore_stepper,
    )
    from fv3net_tpu.parallel.tiling import TileLayout

    phase = "four_cards"
    if len(devices) < 4:
        raise RuntimeError(f"four cards needed, found {len(devices)}")
    devs = devices[:4]
    run1, state, phis = build_config(n, nz, jax, jnp, dt_atmos=dt_atmos,
                                     n_split=n_split)
    host0 = jax.tree_util.tree_map(np.asarray, state)
    phis = jnp.asarray(phis)
    st1 = jax.device_put(state, devs[0])
    ph1 = jax.device_put(phis, devs[0])
    t0 = time.perf_counter()
    comp1 = run1.lower(st1, ph1, 1).compile()
    log(phase, f"one card: compile {time.perf_counter() - t0:.1f} s "
               f"(set-up)")
    one = jax.tree_util.tree_map(np.asarray, comp1(st1, ph1))

    g = CubedSphereGrid.make(n, halo=3)
    lay = TileLayout(n, 3, F=1, Y=2, X=2)
    mesh = Mesh(np.array(devs).reshape(1, 2, 2), ("face", "y", "x"))
    run4, shard, gather = make_tiled_spmd_dycore_stepper(
        g, nz, mesh, lay, dt_atmos=dt_atmos, k_split=1, n_split=n_split,
        hord=5, dtype=jnp.float32,
    )
    st4, phis4 = shard(host0, phis)
    t0 = time.perf_counter()
    comp4 = run4.lower(st4, phis4, 1).compile()
    log(phase, f"four cards: compile {time.perf_counter() - t0:.1f} s "
               f"(set-up)")
    out4, times, first = st4, [], None
    for i in range(steps):
        t0 = time.perf_counter()
        out4 = comp4(out4, phis4)
        jax.block_until_ready(out4)
        times.append(time.perf_counter() - t0)
        if i == 0:
            first = out4
    log(phase, "four-card step times ms: " + ", ".join(
        f"{t * 1e3:.2f}" for t in times) + f" ({card})")

    for k, arr in _fields(first).items():
        shards = arr.addressable_shards
        owners = {s.device for s in shards}
        index = {tuple((sl.start, sl.stop) for sl in s.index)
                 for s in shards}
        if len(owners) != 4 or len(index) != 4 or not owners <= set(devs):
            raise RuntimeError(f"four cards: {k} is not 4 distinct shards")
    log(phase, "every field is 4 distinct shards on "
               + ", ".join(str(d) for d in devs))
    got = jax.tree_util.tree_map(np.asarray, gather(first))
    final = jax.tree_util.tree_map(np.asarray, gather(out4))
    for k, v in _fields(final).items():
        if not np.isfinite(v).all():
            raise RuntimeError(f"four cards: {k} not finite")
    diff = {}
    for k, v in _fields(got).items():
        diff[k] = _max_rel(v, getattr(one, k))
        log(phase, f"4 cards vs 1 card {k}: max|diff|/max {diff[k]:.2e}")
    result = {"step_ms": [t * 1e3 for t in times], "max_rel_diff": diff}
    if cpu_device is not None:
        t0 = time.perf_counter()
        (cpu64,) = cpu_reference_steps(host0, phis, n, nz, dt_atmos,
                                       cpu_device, (np.float64,),
                                       n_split=n_split)
        log(phase, f"CPU float64 step {time.perf_counter() - t0:.1f} s "
                   f"(set-up)")
        check_against_f64(phase, "4 cards", got, "1 card", one, cpu64)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the tiled SPMD step on four cards")
    args = ap.parse_args(argv)
    start = time.perf_counter()
    if AUTOTUNE_FLAG.split("=")[0] not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " " + AUTOTUNE_FLAG
        ).strip()

    import jax

    from bench import card_line
    from fv3net_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    device = check_device(jax.devices())
    log("device", f"{device['kind']} x{device['count']}, "
                  f"jax {jax.__version__}, "
                  f"XLA_FLAGS={os.environ['XLA_FLAGS']!r}")
    card = card_line()
    log("device", f"card: {card}")
    log("device", f"compile cache: {cache_dir}")

    cpu = jax.local_devices(backend="cpu")[0]
    if args.four_cards:
        phases = [lambda: four_card_phase(48, 63, jax.devices(),
                                          cpu_device=cpu, card=card)]
    else:
        phases = [
            lambda: dycore_phase("dycore_c48", 48, 63, 900.0, 3,
                                 cpu_device=cpu, card=card),
            lambda: dycore_phase("dycore_c192", 192, 63, 225.0, 2,
                                 card=card),
            lambda: kernels_phase((48, 192), card=card),
            lambda: coupled_phase(48, 63, 3, card=card),
        ]
    for phase in phases:
        phase()
        log("time", f"{time.perf_counter() - start:.1f} s since start")
    print(card)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
