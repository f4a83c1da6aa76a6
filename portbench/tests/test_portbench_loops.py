"""The load generator: the check's state copies are kept off the
window's clock, the collector is left as the program finds it and its
passes are counted."""

import gc
import time

import pytest

from portbench import harness, loops

KEEP_S = 0.2


class Slow:
    """A system whose calls take CALL_S and whose keep takes KEEP_S."""

    eb = 4
    CALL_S = 0.01

    def __init__(self):
        self.kept = []

    def keep(self, k, after):
        self.kept.append((k, after))
        time.sleep(KEEP_S)

    def call(self, k):
        time.sleep(self.CALL_S)
        return 2 * self.eb

    def reset_stages(self):
        pass


MIXES = {"closed": {"loop": "closed", "windows_per_call": 2},
         "open": {"loop": "open", "windows_per_call": 2, "edges_per_s": 400}}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 9])
def test_kept_copies_are_off_the_clock(mix, seed):
    system = Slow()
    win = loops.run(MIXES[mix], system, 0.3, seed=seed)
    # one call is the sample: its state kept before it and after it
    (k, before), (k2, after) = system.kept
    assert k == k2 and k in win.calls and (before, after) == (False, True)
    assert win.kept_s >= 2 * KEEP_S
    # the window's clock left the copies out; an open loop's calls stay
    # on time however long the copies took
    assert win.seconds < 0.3 + 2 * Slow.CALL_S + 0.05
    if mix == "open":
        assert max(win.lateness_s) < 0.05
        assert max(win.latency_s) < 0.05


def test_a_window_closed_before_its_moment_samples_the_next_call():
    system = Slow()
    system.CALL_S = 0.2
    win = loops.run(MIXES["closed"], system, 0.1, seed=5)
    assert win.timed_calls == [1] and win.calls == [1, 2]
    assert system.kept == [(2, False), (2, True)]


@pytest.mark.parametrize("cell", ["toy.bulk", "toy.live"])
def test_collector_is_not_frozen(toy, cell):
    root, bench = toy
    before = gc.get_freeze_count()
    _, lines = harness.execute(bench, cell, 2 ** 31 + 3, 0.3, False,
                               time.perf_counter(), device="cpu", root=root)
    assert gc.get_freeze_count() == before and gc.isenabled()
    assert any(line.startswith("window: collector passes") for line in lines)
