"""The stream generator: determined by its seed, and bench.py's law."""

import pytest
import torch

from portbench import streams


def pool(seed, n=20000, nv=3000):
    return streams.make_pool(n, nv, streams.generator(seed, "cpu"))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345, 2 ** 40 + 1])
def test_same_seed_same_pool(seed):
    a, b = pool(seed), pool(seed)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_other_seed_other_pool():
    a, b = pool(11), pool(12)
    assert not torch.equal(a[0], b[0])


def test_law():
    src, dst = pool(3, n=200000, nv=5000)
    assert src.dtype == torch.int32 and dst.dtype == torch.int32
    assert int((src == dst).sum()) == 0
    assert 0 <= int(src.min()) and int(src.max()) < 5000
    counts = torch.sort(torch.bincount(src, minlength=5000),
                        descending=True).values.double()
    # Zipf 1.1: the hottest id carries 1 / H(5000, 1.1) of the edges
    # (15.8 %), and rank 10 about 10^-1.1 of rank 1
    expect = 1.0 / float((torch.arange(1, 5001, dtype=torch.float64)
                          ** -1.1).sum())
    assert abs(float(counts[0] / counts.sum()) - expect) < 0.01
    assert 0.06 < counts[9] / counts[0] < 0.10
    # the permutation scatters the hot ids: the hottest is not id 0
    hottest = torch.argsort(torch.bincount(src, minlength=5000),
                            descending=True)[:5]
    assert sorted(hottest.tolist()) != [0, 1, 2, 3, 4]

