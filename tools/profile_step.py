"""Measure the dycore and coupled steps on the GPU: A/B of the vertical
solver, a reduced profiler trace, and set-up costs.

    python tools/profile_step.py ab 48 192     # SIM1 variants end to end
    python tools/profile_step.py trace 48 192 coupled
    python tools/profile_step.py setup 192     # metrics build, halo form

`ab` times the whole C<n> x 63 step with the vertical solver as the
Triton kernel, the jnp scans and the fully unrolled jnp scans, in the
order kernel, scan, unroll, unroll, scan, kernel.  `trace` profiles a
few steps and reduces the trace to kernel count, device busy time,
idle share, and the share of device time under each named scope
(transport, vertical_solver, remap) and inside the step's loops;
the full per-kernel table goes to chiprun_out/.  `setup` times the
metric build on the host CPU against the default device, and compiles
and times C<n> with the affine halo form against the strip gathers.
Every printed time is a host clock around work that ends in
block_until_ready, or device time from the trace, with the card named.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import shutil
import statistics
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out")
SCOPES = ("transport", "vertical_solver", "remap")
DT = {48: 900.0, 96: 450.0, 192: 225.0, 384: 112.5}
NZ = 63


@contextlib.contextmanager
def sim1_variant(name):
    """Trace the dycore with one form of the vertical solver."""
    from fv3net_tpu.dycore import hydro, riemann

    forms = {
        "kernel": hydro.sim1_solve,  # the product path
        "scan": lambda dt, *a, p_fac=0.05: riemann.sim1_solver(
            dt, *a, p_fac),
        "unroll": lambda dt, *a, p_fac=0.05: riemann.sim1_solver(
            dt, *a, p_fac, unroll=True),
    }
    saved = hydro.sim1_solve
    hydro.sim1_solve = forms[name]
    try:
        yield
    finally:
        hydro.sim1_solve = saved


def _timed_steps(compiled, state, phis, k):
    import jax

    t0 = time.perf_counter()
    for _ in range(k):
        state = compiled(state, phis)
    jax.block_until_ready(state)
    return state, (time.perf_counter() - t0) / k


def _setup(n):
    import jax
    import jax.numpy as jnp

    from bench import build_config

    run, state, phis = build_config(n, NZ, jax, jnp, dt_atmos=DT.get(n, 900.0))
    return run, state, jnp.asarray(phis)


def ab(n, card, k=5, variants=("kernel", "scan", "unroll")):
    import jax
    import jax.numpy as jnp

    run, state, phis = _setup(n)
    comp, states = {}, {}
    for v in variants:
        # a fresh trace per variant: jit would reuse the first lowering
        jax.clear_caches()
        with sim1_variant(v):
            t0 = time.perf_counter()
            comp[v] = run.lower(state, phis, 1).compile()
            txt = comp[v].as_text()
            print(f"C{n} {v}: compile {time.perf_counter() - t0:.1f} s, "
                  f"{txt.count(' fusion(')} fusions, "
                  f"{txt.count(' custom-call(')} custom calls", flush=True)
        states[v] = jax.tree_util.tree_map(jnp.copy, state)
        states[v] = comp[v](states[v], phis)  # warm
    times = {v: [] for v in comp}
    for v in (*variants, *variants[::-1]):
        states[v], t = _timed_steps(comp[v], states[v], phis, k)
        times[v].append(t * 1e3)
    for v, ts in times.items():
        print(f"C{n}x{NZ} step, solver={v}: "
              f"{', '.join(f'{t:.3f}' for t in ts)} ms "
              f"(mean of {k} steps per window; {card})", flush=True)
    return {v: statistics.median(ts) for v, ts in times.items()}


def _hlo_scopes(compiled, label=None):
    """HLO instruction name -> the op_names (named-scope paths) of the
    ops it runs: its own and, for a fusion, those of the instructions
    inside its fused computation (a fusion's own metadata is often
    empty)."""
    txt = compiled.as_text()
    if label:
        with gzip.open(os.path.join(OUT, f"hlo_{label}.txt.gz"), "wt") as f:
            f.write(txt)
    comp_ops, calls, own = {}, {}, {}
    cur = None
    head = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) [^=]*\{$")
    inst = re.compile(r"^\s+(?:ROOT )?%([\w.\-]+) = ")
    for line in txt.splitlines():
        m = head.match(line)
        if m:
            cur = m.group(1)
            comp_ops.setdefault(cur, [])
            continue
        m = inst.match(line)
        if not m or cur is None:
            continue
        name = m.group(1)
        op = re.search(r'op_name="([^"]*)"', line)
        own[name] = [op.group(1)] if op else []
        comp_ops[cur].extend(own[name])
        called = re.search(r"calls=%([\w.\-]+)", line)
        if called:
            calls[name] = called.group(1)
    out = {}
    for name, ops in own.items():
        ops = list(ops)
        if name in calls:
            ops += comp_ops.get(calls[name], [])
        out[name] = ops
        out[name.replace(".", "_")] = ops
    return out


def _scope_of(op_names):
    """The scope most of a kernel's ops run under, if any."""
    votes = {k: sum(f"/{k}/" in o for o in op_names) for k in SCOPES}
    best = max(votes, key=votes.get)
    return best if votes[best] else None


def reduce_trace(path, scopes, steps, label):
    """Kernel count, busy time, idle share and per-scope device time
    of a traced window, from the xplane the profiler wrote."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    events, lines = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = (
                len(evs), sum(e.duration_ns for e in evs) / 1e6
            )
            if not line.name.startswith("Stream"):
                continue
            for e in evs:
                st = {k: v for k, v in e.stats}
                events.append((e.start_ns, e.duration_ns, e.name,
                               st.get("hlo_op", "")))
    if not events:
        return {"error": "no GPU kernel events", "lines": lines}
    events.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, d, _, _ in events:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    busy += cur_e - cur_s
    window = max(s + d for s, d, _, _ in events) - events[0][0]
    total = sum(d for _, d, _, _ in events)
    by_scope = {k: 0.0 for k in SCOPES}
    in_loop = 0.0
    per_kernel = {}
    for _, d, name, op in events:
        ops = scopes.get(op) or scopes.get(name) or []
        scope = _scope_of(ops)
        if scope:
            by_scope[scope] += d
        # the acoustic substep loop is the third nested while (steps,
        # k_split, n_split); remap's own scans sit at the second
        if any(o.count("/while/body/") >= 3 and "/remap/" not in o
               for o in ops):
            in_loop += d
        op_name = ops[0] if ops else ""
        row = per_kernel.setdefault(name, [0, 0.0, op_name])
        row[0] += 1
        row[1] += d / 1e6
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"kernels_{label}.tsv"), "w") as f:
        f.write("ms\tcount\tkernel\top_name\n")
        for name, (c, ms, op_name) in sorted(
            per_kernel.items(), key=lambda kv: -kv[1][1]
        ):
            f.write(f"{ms:.4f}\t{c}\t{name}\t{op_name}\n")
    return {
        "kernels_per_step": len(events) / steps,
        "kernel_time_ms_per_step": total / 1e6 / steps,
        "busy_ms_per_step": busy / 1e6 / steps,
        "idle_share": 1.0 - busy / window,
        "scope_share_of_kernel_time": {
            k: v / total for k, v in by_scope.items()
        },
        "substep_loop_share_of_kernel_time": in_loop / total,
        "lines": lines,
    }


def _trace(label, fn, compiled, steps):
    import jax

    d = os.path.join(OUT, f"trace_{label}")
    with jax.profiler.trace(d):
        jax.block_until_ready(fn())
    path = sorted(glob.glob(f"{d}/**/*.xplane.pb", recursive=True))[-1]
    r = reduce_trace(path, _hlo_scopes(compiled, label), steps, label)
    shutil.rmtree(d)  # the reduction is what comes back
    print(f"trace {label}: " + json.dumps(
        {k: v for k, v in r.items() if k != "lines"}), flush=True)
    with open(os.path.join(OUT, f"trace_{label}.json"), "w") as f:
        json.dump(r, f, indent=1)
    return r


def transport_roofline(n, card, peak_gbs, k=20):
    """fv_tp_2d alone at the step's padded C<n> x 63 shapes: time, the
    bytes its inputs and outputs must move, and the share of peak."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fv3net_tpu.ops.advection import fv_tp_2d

    N = n + 6
    rng = np.random.RandomState(0)
    sh = (6, 63, N, N)
    f = lambda s, a=1.0: jnp.asarray(  # noqa: E731
        a * rng.randn(*s), jnp.float32)
    args = (f(sh), f(sh), f(sh, 0.2), f(sh, 0.2), f(sh), f(sh),
            1.0 + jnp.abs(f((6, 1, N, N))), 1.0 + jnp.abs(f((6, 1, N, N))))
    fn = jax.jit(lambda *a: fv_tp_2d(*a, 5))
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(k):
        out = fn(*args)
    jax.block_until_ready(out)
    t = (time.perf_counter() - t0) / k
    nbytes = sum(a.size for a in args) * 4 + 2 * np.prod(sh) * 4
    share = nbytes / t / (peak_gbs * 1e9)
    print(f"fv_tp_2d C{n}x{NZ} alone: {t * 1e3:.3f} ms, {nbytes / 1e6:.1f} MB"
          f" moved at least, {share:.3f} of {peak_gbs:.0f} GB/s ({card})",
          flush=True)
    return t, share


def trace_dycore(n, card, steps=3):
    import jax

    from bench import hbm_peak_gbs

    run, state, phis = _setup(n)
    compiled = run.lower(state, phis, 1).compile()
    st = [compiled(state, phis)]
    st[0] = compiled(st[0], phis)
    st[0], t = _timed_steps(compiled, st[0], phis, steps)
    print(f"C{n}x{NZ} step {t * 1e3:.3f} ms ({card})", flush=True)

    def window():
        for _ in range(steps):
            st[0] = compiled(st[0], phis)
        return st[0]

    r = _trace(f"c{n}", window, compiled, steps)
    if n >= 192:
        transport_roofline(n, card,
                           hbm_peak_gbs(jax.devices()[0].device_kind))
    return r


def trace_coupled(card, steps=3, n=48, nz=NZ):
    import jax

    from bench import dense_ml_model
    from chip_smoke import _coupled_init

    wrapper = _coupled_init(n, nz, 900.0)
    try:
        from fv3net_tpu.runtime.compiled_loop import CompiledTimeLoop

        loop = CompiledTimeLoop(wrapper, ml_model=dense_ml_model(nz))
        for _ in range(2):
            loop.step()
        loop.block()
        t0 = time.perf_counter()
        for _ in range(steps):
            loop.step()
        loop.block()
        print(f"coupled C48 step "
              f"{(time.perf_counter() - t0) / steps * 1e3:.3f} ms "
              f"({card})", flush=True)
        mdl = loop.mdl
        cosz, solcon = loop._astronomy()
        args = (mdl.state, mdl.phis, loop._tsfc,
                jax.numpy.asarray(mdl.total_precip, mdl.dtype),
                jax.numpy.asarray(cosz), jax.numpy.asarray(solcon))
        compiled = loop._step_fn.lower(*args).compile()

        def window():
            for _ in range(steps):
                loop.step()
            return loop.mdl.state

        return _trace("coupled_c48", window, compiled, steps)
    finally:
        wrapper.cleanup()


def setup_costs(n, card):
    import jax
    import jax.numpy as jnp

    from fv3net_tpu.dycore.sw import SWMetrics
    from fv3net_tpu.grid import CubedSphereGrid, halo

    g = CubedSphereGrid.make(n, halo=3)
    for where, dev in (("host cpu", jax.local_devices(backend="cpu")[0]),
                       ("default device", jax.local_devices()[0])):
        t0 = time.perf_counter()
        with jax.default_device(dev):
            m = SWMetrics.make(g, jnp.float32)
            jax.block_until_ready(m.rarea)
        print(f"C{n} metrics build on {where}: "
              f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)
    res = {}
    for form, limit in (("strip gathers", halo.AFFINE_MAX_N),
                        ("affine", 10 ** 6)):
        saved = halo.AFFINE_MAX_N
        halo.AFFINE_MAX_N = limit
        try:
            run, state, phis = _setup(n)
            t0 = time.perf_counter()
            compiled = run.lower(state, phis, 1).compile()
            tc = time.perf_counter() - t0
        finally:
            halo.AFFINE_MAX_N = saved
        st = compiled(state, phis)
        ts = []
        for _ in range(3):
            st, t = _timed_steps(compiled, st, phis, 3)
            ts.append(t * 1e3)
        res[form] = (tc, ts)
        print(f"C{n}x{NZ} halo form {form}: compile {tc:.1f} s, step "
              f"{', '.join(f'{t:.3f}' for t in ts)} ms ({card})",
              flush=True)
    return res


def compile_cost(n, card):
    """Trace+lower and XLA compile times of the C<n> step, uncached."""
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
    run, state, phis = _setup(n)
    t0 = time.perf_counter()
    lowered = run.lower(state, phis, 1)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    txt = compiled.as_text()
    print(f"C{n}x{NZ} trace+lower {t1 - t0:.1f} s, compile {t2 - t1:.1f} s, "
          f"{txt.count(' fusion(')} fusions, XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r} ({card})", flush=True)


def step_time(n, card, k=5):
    """Compile (or load) the C<n> step and time three windows."""
    run, state, phis = _setup(n)
    t0 = time.perf_counter()
    compiled = run.lower(state, phis, 1).compile()
    tc = time.perf_counter() - t0
    st = compiled(state, phis)
    ts = []
    for _ in range(3):
        st, t = _timed_steps(compiled, st, phis, k)
        ts.append(t * 1e3)
    print(f"C{n}x{NZ} step {', '.join(f'{t:.3f}' for t in ts)} ms "
          f"(compile or cache load {tc:.1f} s), XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r} ({card})", flush=True)


def main(argv):
    import jax

    from bench import card_line
    from fv3net_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    print(f"{jax.devices()[0].device_kind} x{len(jax.devices())}: {card}",
          flush=True)
    mode, args = argv[0], argv[1:]
    for a in args:
        if mode == "ab":
            ab(int(a), card)
        elif mode == "trace" and a == "coupled":
            trace_coupled(card)
        elif mode == "trace":
            trace_dycore(int(a), card)
        elif mode == "setup":
            setup_costs(int(a), card)
        elif mode == "compile":
            compile_cost(int(a), card)
        elif mode == "steptime":
            step_time(int(a), card)
        else:
            raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
