"""A/B the cheap C-grid half-stage (hydro.dyn_substep c_half) on the
GPU.

Measures the nonhydrostatic dycore step at the given resolutions with
the steady-state congestion-guarded timer used by bench.py.

    python tools/ab_c_half.py 192 [48 ...] [--legacy]

--legacy also measures c_half=False (the round-2..4 midpoint scheme)
for a same-session comparison; by default only the new scheme runs
(the banked r5 ladder is the legacy baseline).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def measure(n, nz, c_half, jax, jnp):
    import numpy as np

    from fv3net_tpu.dycore.hydro import (
        add_nonhydrostatic_fields,
        make_dycore_stepper,
    )
    from fv3net_tpu.grid import CubedSphereGrid
    from fv3net_tpu.utils.benchtime import steady_state_timing
    from __graft_entry__ import _rest_state

    dt_atmos = {48: 900.0, 96: 450.0, 192: 225.0, 384: 112.5}[n]
    g = CubedSphereGrid.make(n, halo=3)
    t0 = time.perf_counter()
    run, m, _ = make_dycore_stepper(
        g, nz, dt_atmos=dt_atmos, k_split=1, n_split=6, hord=5,
        dtype=jnp.float32, donate=True, c_half=c_half,
    )
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        state = jax.tree_util.tree_map(
            jnp.asarray, _rest_state(g, nz, 300.0, jnp.float32)
        )
        rng = np.random.RandomState(0)
        state = state._replace(
            pt=state.pt
            + jnp.asarray(rng.randn(*state.pt.shape).astype(np.float32)),
        )
        state = add_nonhydrostatic_fields(state, 300.0)
    build_s = time.perf_counter() - t0
    dev = jax.devices()[0]
    state = jax.device_put(state, dev)
    phis = jax.device_put(jnp.zeros((6, n, n), jnp.float32), dev)
    t0 = time.perf_counter()
    box = [run(state, phis, 1)]
    box[0].delp.block_until_ready()
    compile_s = time.perf_counter() - t0

    def step():
        box[0] = run(box[0], phis, 1)

    def fetch():
        jax.block_until_ready(box[0])

    r = steady_state_timing(
        step, fetch, lambda: 600.0, target_batch_s=1.0
    )
    assert bool(jnp.isfinite(box[0].delp).all()), "state blew up"
    ms = r["step_s"] * 1e3
    ups = 6 * n * n * nz * 6 / r["step_s"]
    print(
        f"C{n} c_half={c_half}: {ms:.1f} ms/step "
        f"({ups / 1e6:.1f}M updates/s) build {build_s:.0f}s "
        f"compile {compile_s:.0f}s batches {r['batch_ms']} "
        f"clean {r['clean']}",
        flush=True,
    )


def main():
    import jax
    import jax.numpy as jnp

    ns = [int(a) for a in sys.argv[1:] if a.isdigit()] or [192]
    legacy = "--legacy" in sys.argv
    print("backend:", jax.default_backend(), flush=True)
    for n in ns:
        measure(n, 63, True, jax, jnp)
        if legacy:
            measure(n, 63, False, jax, jnp)


if __name__ == "__main__":
    main()
