"""The premise of the GNN round's tensor-core product (gelly_streaming_
tpu_torch/csrc/gnn_round.cu), checked on the CPU: lattice operands are
exact in fp16, and a product taken as the kernel's `wgmma` takes it
(fp16 operands, fp32 sums over k-steps of 16, in any order) equals the
plain version's float64 product (`gnn_round.lattice_product`) bit for
bit at every width the kernel takes. bf16 would round the same operands,
so the premise is not vacuous. The lattice helpers are held against the
JAX package's. Inputs from numpy seeds; equality, no tolerance.
"""

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import gnn_window as jax_gw
from gelly_streaming_tpu_torch.ops import gnn_round
from gelly_streaming_tpu_torch.ops import gnn_window as gw

FEATURE_DIMS = [1, 8, 16, 64, 72, 128, 256]
ROWS = 48
K_STEP = 16          # the k depth of one wgmma.m64n64k16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _operands(F, seed):
    """(p, W) on the lattice at width F: p integers in [0, 511] with one
    row saturated, W snapped (snap_weights) with a column at +cap and
    one at -cap, so the largest sums the lattice allows occur."""
    rng = np.random.default_rng(seed)
    cap = gw.weight_cap(F)
    assert cap == jax_gw.weight_cap(F)
    W = rng.integers(-cap, cap + 1, (F, F)).astype(np.float64)
    W[:, -1] = -cap
    W[:, 0] = cap
    Wu, _bu = gw.snap_weights(W / 2 ** gw.Q_BITS, np.zeros(F), F)
    assert np.array_equal(Wu, W)
    p = rng.integers(0, gnn_round.UNIT_CAP + 1, (ROWS, F))
    p[0] = gnn_round.UNIT_CAP
    return torch.from_numpy(p.astype(np.float32)), torch.from_numpy(Wu)


def _mma_product(p, W, dtype, seed):
    """p @ W as the kernel's tensor cores take it: operands rounded to
    `dtype`, k cut into steps of K_STEP, each step's products summed in
    float32 in a shuffled order, the steps added into the float32
    accumulator in a shuffled order."""
    rng = np.random.default_rng(seed)
    pr, Wr = p.to(dtype).float(), W.to(dtype).float()
    F = W.shape[0]
    steps = [np.arange(k0, min(k0 + K_STEP, F))
             for k0 in range(0, F, K_STEP)]
    acc = torch.zeros(p.shape[0], F, dtype=torch.float32)
    for i in rng.permutation(len(steps)):
        part = torch.zeros_like(acc)
        for k in rng.permutation(steps[i]):
            part += pr[:, k:k + 1] * Wr[k:k + 1, :]
        acc += part
    return acc


@pytest.mark.parametrize("F", FEATURE_DIMS)
def test_lattice_operands_exact_in_fp16(F):
    """Every feature value 0..511 and every weight in [-cap, cap]
    survives the cast to fp16 unchanged, as do the snapped operands."""
    cap = gw.weight_cap(F)
    feats = torch.arange(0, gnn_round.UNIT_CAP + 1, dtype=torch.float32)
    weights = torch.arange(-cap, cap + 1, dtype=torch.float32)
    p, W = _operands(F, seed=F)
    for x in (feats, weights, p, W):
        assert torch.equal(x.to(torch.float16).float(), x)
    # the largest |partial sum| stays below 2^24
    assert gnn_round.UNIT_CAP * cap * F < 2 ** 24


@pytest.mark.parametrize("F", FEATURE_DIMS)
def test_fp16_mma_product_equals_plain(F):
    """The emulated tensor-core product (fp16 operands, fp32 sums in
    shuffled k-steps) equals lattice_product, the plain version's
    float64 product, for two shuffles."""
    p, W = _operands(F, seed=100 + F)
    want = gnn_round.lattice_product(p, W)
    assert want.abs().max() < 2 ** 24
    assert want[0, 0] == gnn_round.UNIT_CAP * gw.weight_cap(F) * F
    for seed in (0, 1):
        got = _mma_product(p, W, torch.float16, seed)
        assert torch.equal(got, want)


@pytest.mark.parametrize("F", FEATURE_DIMS)
def test_bf16_would_round(F):
    """bf16 (8 significant bits) rounds features above 256, and weights
    above 256 where the cap allows them, so its product differs."""
    cap = gw.weight_cap(F)
    weights = torch.arange(-cap, cap + 1, dtype=torch.float32)
    assert torch.equal(weights.to(torch.bfloat16).float(),
                       weights) == (cap <= 256)
    p, W = _operands(F, seed=200 + F)
    assert not torch.equal(p.to(torch.bfloat16).float(), p)
    got = _mma_product(p, W, torch.bfloat16, 0)
    assert not torch.equal(got, gnn_round.lattice_product(p, W))
