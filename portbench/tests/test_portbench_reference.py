"""The plain reference against the port's plain path on the CPU: every
window's summaries and the slab bit for bit; the control precision
differs."""

import hashlib

import numpy as np
import pytest
import torch

from portbench import streams
from portbench.reference import gcn_round as ref_mod
from portbench.systems.gnn_summary import make_weights

CASES = [  # vertices, edge bucket, width, activation, edges
    (100, 256, 16, "relu", 256 * 5 + 17),
    (300, 1024, 256, "relu", 1024 * 3),
    (50, 64, 8, "abs", 64 * 7 + 3),
    (1000, 65536, 32, "identity", 65536 + 100),   # aggregation shift 1
]


def digest(h: torch.Tensor) -> str:
    return hashlib.sha256(h.contiguous().numpy().tobytes()).hexdigest()


def run_both(nv, eb, F, act, n, seed=2 ** 31 + 5):
    from gelly_streaming_tpu_torch.ops.gnn_window import GnnSummaryEngine

    gen = streams.generator(seed, "cpu")
    src, dst = streams.make_pool(n, nv, gen)
    W, b = make_weights(F, gen)
    eng = GnnSummaryEngine(eb, nv, F, act, device="cpu")
    eng.set_weights(W.numpy(), b.numpy())
    out = eng.process(src.numpy(), dst.numpy())
    prog = torch.tensor([[o["max_feat"], o["active_vertices"],
                          o["feat_checksum"], o["msg_edges"]] for o in out])
    slab = torch.from_numpy(eng.state_dict()["carry"][0])
    return prog, slab, (src, dst, W, b)


@pytest.mark.parametrize("nv,eb,F,act,n", CASES)
def test_reference_equals_plain_path(nv, eb, F, act, n):
    prog, slab, (src, dst, W, b) = run_both(nv, eb, F, act, n)
    ref = ref_mod.GcnRound(nv, eb, F, act, W, b)
    h, table = ref.run(ref.fresh_slab("cpu"), src, dst)
    assert torch.equal(prog, table)
    assert digest(h) == digest(slab)
    assert ref_mod.slab_checksum(h) == int(table[-1, 2])


@pytest.mark.parametrize("nv,eb,F,act,n", CASES[:2])
def test_control_precision_differs(nv, eb, F, act, n):
    prog, slab, (src, dst, W, b) = run_both(nv, eb, F, act, n)
    ctl = ref_mod.GcnRound(nv, eb, F, act, W, b, precision="fp8")
    h, table = ctl.run(ctl.fresh_slab("cpu"), src, dst)
    assert (table != prog).any(dim=1).sum() > 0
    assert (h != slab).sum() > 0


def test_reference_works_out_the_program_derivations():
    assert ref_mod.bucket(169343) == 262144
    assert ref_mod.bucket(2449029) == 4194304
    assert ref_mod.bucket(3) == 8
    assert [ref_mod.agg_shift(e) for e in (32768, 32769, 65536, 256)] == \
        [0, 1, 1, 0]
    assert [ref_mod.weight_cap(F) for F in (8, 64, 65, 128, 256)] == \
        [512, 512, 256, 256, 128]
    W = torch.tensor([[0.51 / 32, -9.0], [1.5 / 32, 2.5 / 32]])
    Wu, bu = ref_mod.snap(W, torch.tensor([0.5 / 32, 100.0]), 2)
    assert Wu.tolist() == [[1.0, -288.0], [2.0, 2.0]]   # half to even, cap
    assert bu.tolist() == [0.0, 512.0]


def test_hold_rule_on_an_empty_window():
    ref = ref_mod.GcnRound(10, 8, 4, "relu", torch.eye(4), torch.zeros(4))
    h = torch.arange(17 * 4, dtype=torch.float32).reshape(17, 4) % 7
    h[16] = 0
    s = torch.zeros(8, dtype=torch.int64)
    out, sums = ref.window(h, s, s, torch.zeros(8, dtype=torch.bool))
    assert out is h and int(sums[3]) == 0
    assert int(sums[2]) == int(h.sum())
    np.testing.assert_array_equal(int(sums[0]), 6)
