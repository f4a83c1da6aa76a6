"""The check of `correct` against a broken timed path: each fault the
cells can have, planted in the program under a whole toy run on the
CPU, and the control (the reference at fp8 in the program's place),
must come out not correct; the sound program must come out correct.
The cells run on one card, so no exchange between cards can be left
out."""

import time

import pytest
import torch

from portbench import harness
from gelly_streaming_tpu_torch.ops import gnn_round, gnn_window


def run(toy, cell="toy.bulk", program="engine", seed=2 ** 31 + 29):
    root, bench = toy
    res, _ = harness.execute(bench, cell, seed, 0.3, False,
                             time.perf_counter(), device="cpu",
                             program=program, root=root)
    return res


def state_unchanged(monkeypatch):
    orig = gnn_round.gnn_rounds_plain

    def frozen(h, W, b, src, dst, valid, act, sums):
        keep = h.clone()
        orig(h, W, b, src, dst, valid, act, sums)
        h.copy_(keep)

    monkeypatch.setattr(gnn_round, "gnn_rounds_plain", frozen)


def half_batch(monkeypatch):
    orig = gnn_round.gnn_rounds_plain

    def halved(h, W, b, src, dst, valid, act, sums):
        # the odd slots left out, the even ones counted twice: the sum
        # over the window taken as twice the sum over half of it
        src, dst = src.clone(), dst.clone()
        n = src.shape[1] // 2
        src[:, 1:2 * n:2] = src[:, 0:2 * n:2]
        dst[:, 1:2 * n:2] = dst[:, 0:2 * n:2]
        orig(h, W, b, src, dst, valid, act, sums)

    monkeypatch.setattr(gnn_round, "gnn_rounds_plain", halved)


def answer_altered(monkeypatch):
    orig = gnn_window.GnnEngineBase._finalize_summaries

    def altered(self, at, res, src, dst, out):
        res = res.copy()
        res[2, -1] += 1          # one window's checksum a chunk
        orig(self, at, res, src, dst, out)

    monkeypatch.setattr(gnn_window.GnnEngineBase, "_finalize_summaries",
                        altered)


def slab_altered(monkeypatch):
    orig = gnn_round.gnn_rounds_plain

    def bumped(h, W, b, src, dst, valid, act, sums):
        orig(h, W, b, src, dst, valid, act, sums)
        h[0, 0] = torch.clamp(h[0, 0] + 1, max=511) if h[0, 0] < 511 \
            else h[0, 0] - 1

    monkeypatch.setattr(gnn_round, "gnn_rounds_plain", bumped)


def window_dropped(monkeypatch):
    orig = gnn_window.GnnEngineBase._finalize_summaries

    def dropped(self, at, res, src, dst, out):
        orig(self, at, res, src, dst, out)
        out.pop()                # a chunk's last window never delivered

    monkeypatch.setattr(gnn_window.GnnEngineBase, "_finalize_summaries",
                        dropped)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered, "slab_altered": slab_altered,
          "window_dropped": window_dropped}


@pytest.mark.parametrize("cell", ["toy.bulk", "toy.live"])
def test_sound_program_is_correct(toy, cell):
    res = run(toy, cell)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["toy.bulk", "toy.live"])
def test_fault_is_caught(toy, monkeypatch, fault, cell):
    FAULTS[fault](monkeypatch)
    res = run(toy, cell)
    assert not res["correct"], (fault, res["checks"])
    if fault == "window_dropped":
        assert res["failed"] > 0
        assert res["checks"]["run_windows_off"]["value"] >= res["failed"]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 2 ** 33 + 1])
def test_control_is_not_correct(toy, seed):
    res = run(toy, program="control", seed=seed)
    assert not res["correct"]
    assert res["checks"]["sample_windows_off"]["value"] > 0
