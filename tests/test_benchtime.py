"""The bench's steady-state timing guard must ACT on noisy windows:
re-run them, bank min-of-clean-batches, and refuse a headline when no
clean consensus exists.  Pure logic, tested with a fake clock."""

from fv3net_tpu.utils.benchtime import steady_state_timing


class FakeDevice:
    """step() costs `durations.pop(0)` fake seconds per iteration;
    fetch() costs rtt."""

    def __init__(self, durations, rtt=0.03):
        self.durations = list(durations)
        self.rtt = rtt
        self.t = 0.0
        self.pending = 0.0

    def clock(self):
        return self.t

    def step(self):
        d = self.durations.pop(0) if self.durations else 0.1
        self.pending += d

    def fetch(self):
        self.t += self.pending + self.rtt
        self.pending = 0.0


def _run(durations, rtt=0.03, budget=1e9):
    dev = FakeDevice(durations, rtt)
    return steady_state_timing(
        dev.step, dev.fetch, remaining_s=lambda: budget,
        clock=dev.clock, target_batch_s=0.5,
    )


def test_clean_run_banks_min():
    # settle x2, probe x1, then batches of k=5 at 0.1 s
    r = _run([0.1] * 100)
    assert r["clean"]
    assert abs(r["step_s"] - 0.1) < 1e-6
    assert r["iters_per_batch"] == 5
    assert len(r["batch_ms"]) == 2  # two clean batches suffice


def test_congested_first_window_is_rerun_not_banked():
    # settle+probe fast, first batch congested 4x, then clean
    dur = [0.1] * 3 + [0.4] * 5 + [0.1] * 100
    r = _run(dur)
    assert r["clean"]
    assert abs(r["step_s"] - 0.1) < 1e-6
    assert len(r["batch_ms"]) >= 3  # the congested window forced extras
    assert r["congestion_spread"] > 0.5  # and is visible in the record


def test_all_congested_refuses_headline():
    # monotonically drifting times: no two batches agree within 10%
    dur = [0.1] * 3 + [
        0.1 * (1.5 ** i) for i in range(60) for _ in range(1)
    ]
    r = _run(dur)
    assert not r["clean"]


def test_budget_exhaustion_stops_rerolls():
    # budget exhausted from the start: the two mandatory windows run
    # (one congested, one clean) but no re-rolls happen, so there is
    # no clean consensus to bank
    dev = FakeDevice([0.1] * 3 + [0.4] * 5 + [0.1] * 200)
    r = steady_state_timing(
        dev.step, dev.fetch, remaining_s=lambda: 1.0,
        clock=dev.clock, target_batch_s=0.5,
    )
    assert len(r["batch_ms"]) == 2
    assert not r["clean"]


def test_huge_rtt_marks_dirty():
    r = _run([0.1] * 100, rtt=0.5)
    assert not r["clean"]
