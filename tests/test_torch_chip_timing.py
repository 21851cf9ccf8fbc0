"""The bookkeeping of chip_smoke.py's kernel timer on the CPU, with stub
events in place of CUDA's: ``time_turns`` times each launch in its own event
pair, in turns (kernel, library, library, kernel, ...), after one warm-up
launch each, runs ``before`` outside the pairs, and returns the median, the
least and the largest time of each function; ``bound_shares`` never gives a
reading under the HBM time of its bytes as a share of the bound."""

import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


class _Clock:
    def __init__(self):
        self.t = 0.0
        self.log = []


class _Event:
    def __init__(self, clock):
        self.clock = clock
        self.t = None

    def record(self):
        self.t = self.clock.t

    def elapsed_time(self, other):
        return other.t - self.t


def _fn(clock, name, durations):
    it = iter(durations)

    def fn():
        clock.log.append(name)
        clock.t += next(it)
    return fn


@pytest.mark.parametrize("reps", [1, 4, 21])
def test_time_turns_median_in_turns(reps):
    clock = _Clock()
    # the warm-up launch first, then reps timed ones of each function
    a_times = [100.0] + [float(i) for i in range(reps, 0, -1)]
    b_times = [100.0] + [2.0 * i for i in range(reps)]

    def before():
        clock.log.append("before")
        clock.t += 1000.0  # outside every event pair

    out = chip_smoke.time_turns([_fn(clock, "a", a_times), _fn(clock, "b", b_times)], reps,
                                lambda: _Event(clock), lambda: None, before)
    assert [o["n"] for o in out] == [reps, reps]
    timed_a, timed_b = sorted(a_times[1:]), sorted(b_times[1:])
    mid = (reps - 1) // 2, reps // 2
    assert out[0]["ms"] == (timed_a[mid[0]] + timed_a[mid[1]]) / 2
    assert out[1]["ms"] == (timed_b[mid[0]] + timed_b[mid[1]]) / 2
    assert (out[0]["min"], out[0]["max"]) == (timed_a[0], timed_a[-1])
    assert (out[1]["min"], out[1]["max"]) == (timed_b[0], timed_b[-1])
    launches = [x for x in clock.log if x != "before"]
    assert launches[:2] == ["a", "b"]
    turns = [x for i in range(reps) for x in (("a", "b") if i % 2 == 0 else ("b", "a"))]
    assert launches[2:] == turns
    assert clock.log[2:] == [x for t in turns for x in ("before", t)]


def test_bound_shares_flags_l2_readings():
    row = {"ms": 0.004, "library_ms": 0.02, "cold_ms": 0.012, "library_cold_ms": None,
           "bound_ms": 0.01}
    got = chip_smoke.bound_shares(row, 0.01)
    assert got == {"l2": True, "library_l2": False, "library_x_bound": 2.0,
                   "cold_l2": False, "cold_x_bound": pytest.approx(1.2)}
