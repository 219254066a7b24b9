"""Steady-state timing discipline for the benchmark.

Every timed window ends in the caller's `fetch`, which waits for the
device (`jax.block_until_ready` on the step's output).  A window taken
while something else loads the host can read slower than steady state,
so the guard ACTS: windows are re-run until a clean consensus exists,
the banked value is the min over clean windows, and a measurement with
no clean consensus is flagged `clean=False` so the caller refuses to
emit it as a headline.

Pure logic over injected `step`/`fetch`/`clock` callables -- unit
tested with a fake clock in tests/test_benchtime.py.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


def steady_state_timing(
    step: Callable[[], None],
    fetch: Callable[[], None],
    remaining_s: Callable[[], float],
    clock: Callable[[], float] = time.perf_counter,
    target_batch_s: float = 1.0,
    min_clean: int = 2,
    max_batches: int = 8,
    clean_tol: float = 0.10,
    rtt_limit_s: float = 0.15,
    reserve_s: float = 10.0,
):
    """Measure steady-state per-iteration wall time.

    step() dispatches one iteration; fetch() waits for all dispatched
    work (block_until_ready); remaining_s() is the caller's budget.
    Returns a dict:

      step_s           min over CLEAN batches (the banked value)
      batch_ms         every batch mean, for the record
      fetch_rtt_ms     measured cost of an idle fetch (subtracted)
      congestion_spread  (max-min)/mean over all batches
      clean            True iff >= min_clean batches agree with the
                       min to within clean_tol AND the rtt was sane --
                       callers must not bank a headline when False
      iters_per_batch

    A batch is "clean" if its mean is within clean_tol of the current
    minimum; congested batches trigger additional windows (up to
    max_batches or the budget) instead of being averaged in.
    """
    # settle: two throwaway iterations absorb post-compile backlog
    step()
    step()
    fetch()
    t0 = clock()
    fetch()
    rtt = clock() - t0
    # probe one iteration for batch sizing
    t0 = clock()
    step()
    fetch()
    probe = max(clock() - t0 - rtt, 1e-4)
    k = max(1, min(12, int(target_batch_s / probe)))

    batch_ms = []

    def run_batch():
        t0 = clock()
        for _ in range(k):
            step()
        fetch()
        batch_ms.append((clock() - t0 - rtt) / k * 1e3)

    def n_clean():
        if not batch_ms:
            return 0
        lo = min(batch_ms)
        return sum(1 for b in batch_ms if b <= lo * (1 + clean_tol))

    while len(batch_ms) < max_batches and (
        len(batch_ms) < min_clean
        or (
            n_clean() < min_clean
            and remaining_s() > reserve_s + k * probe
        )
    ):
        if len(batch_ms) >= min_clean and remaining_s() <= (
            reserve_s + k * probe
        ):
            break
        run_batch()

    lo = min(batch_ms)
    mean = sum(batch_ms) / len(batch_ms)
    spread = (max(batch_ms) - lo) / mean if mean else 0.0
    clean = n_clean() >= min_clean and rtt < rtt_limit_s
    return {
        "step_s": lo / 1e3,
        "batch_ms": [round(b, 1) for b in batch_ms],
        "fetch_rtt_ms": round(rtt * 1e3, 1),
        "congestion_spread": round(spread, 3),
        "clean": bool(clean),
        "iters_per_batch": k,
    }
