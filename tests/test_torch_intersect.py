"""The port's row intersection (gelly_streaming_tpu_torch/ops/intersect.py)
held against the JAX package's `triangles.intersect_local` (the XLA
compare) and `pallas_intersect.intersect_local_pallas` (the Pallas
kernel, in interpret mode on the CPU as its own tests run it).

On the CPU the port's wrapper runs the plain PyTorch version; the CUDA
kernel is held against that plain version on the card by chip_smoke.py.
Counts are integers: equality, no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import pallas_intersect
from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu_torch.ops import intersect as port


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(rng, vb, k, shuffle):
    """The fixture of tests/library/test_triangles.py:143-149 (sorted
    rows, in-row duplicates turned into the sentinel); `shuffle` also
    blanks a share of entries and permutes each row — deduplicated rows
    in no order, as the CUDA window counter lays them out."""
    fill = rng.integers(0, vb, size=(vb + 1, k)).astype(np.int32)
    fill.sort(axis=1)
    dup = np.concatenate(
        [np.zeros((vb + 1, 1), bool), fill[:, 1:] == fill[:, :-1]], axis=1)
    nbr = np.where(dup, vb, fill).astype(np.int32)
    if shuffle:
        nbr = np.where(rng.random(nbr.shape) < 0.3, vb, nbr)
        nbr = np.take_along_axis(nbr, rng.random(nbr.shape).argsort(1), 1)
    return nbr.astype(np.int32)


def _case(seed, vb, k, ep, shuffle):
    rng = np.random.default_rng(seed)
    nbr = _rows(rng, vb, k, shuffle)
    ea = rng.integers(0, vb, ep).astype(np.int32)
    eb = rng.integers(0, vb, ep).astype(np.int32)
    emask = rng.random(ep) < 0.9
    return nbr, ea, eb, emask


def _port(nbr, ea, eb, emask, ascending=False):
    out = port.intersect_local(*(torch.from_numpy(x)
                                 for x in (nbr, ea, eb, emask)),
                               ascending=ascending)
    assert out.dtype == torch.int32 and out.dim() == 0
    return int(out)


CASES = [
    # test_triangles.py:143 shapes: ten TILE_E tiles, two K chunks
    (0, 64, 160, 600, False), (1, 64, 160, 600, False),
    (2, 64, 160, 600, False),
    # deduplicated rows in no order, ragged edge counts, K < and > 128
    (3, 64, 160, 600, True), (4, 200, 48, 333, True),
    (5, 30, 300, 129, True), (6, 64, 8, 1, True),
]


@pytest.mark.parametrize("seed,vb,k,ep,shuffle", CASES)
def test_plain_matches_jax_compare_and_pallas(seed, vb, k, ep, shuffle):
    nbr, ea, eb, emask = _case(seed, vb, k, ep, shuffle)
    args = tuple(jnp.asarray(x) for x in (nbr, ea, eb, emask))
    want = int(jax_tri.intersect_local(*args))
    assert int(pallas_intersect.intersect_local_pallas(*args)) == want
    assert _port(nbr, ea, eb, emask) == want


@pytest.mark.parametrize("seed,vb,k,ep", [(21, 64, 160, 600),
                                          (22, 200, 48, 333)])
def test_ascending_rows_match_jax(seed, vb, k, ep):
    """Rows strictly ascending with the fill at the end, the form
    `ascending=True` promises (triangle_count_sparse's rows): the same
    count as the JAX compare and Pallas kernel."""
    nbr, ea, eb, emask = _case(seed, vb, k, ep, False)
    nbr = np.sort(nbr, axis=1)                # the fill (vb) to the end
    assert (np.diff(nbr, axis=1)[nbr[:, 1:] < vb] > 0).all()
    args = tuple(jnp.asarray(x) for x in (nbr, ea, eb, emask))
    want = int(jax_tri.intersect_local(*args))
    assert int(pallas_intersect.intersect_local_pallas(*args)) == want
    assert _port(nbr, ea, eb, emask, ascending=True) == want > 0


def test_plain_matches_pallas_multi_slab(monkeypatch):
    """The fixture of test_triangles.py:158-181: the Pallas wrapper's
    slab loop (MAX_TILES shrunk to 2) against the port."""
    monkeypatch.setattr(pallas_intersect, "MAX_TILES", 2)
    nbr, ea, eb, emask = _case(11, 64, 128, 300, False)
    args = tuple(jnp.asarray(x) for x in (nbr, ea, eb, emask))
    want = int(pallas_intersect.intersect_local_pallas(*args))
    assert want == int(jax_tri.intersect_local(*args))
    assert _port(nbr, ea, eb, emask) == want


def test_degenerate_shapes():
    nbr, ea, eb, emask = _case(7, 16, 8, 40, True)
    assert _port(nbr, ea[:0], eb[:0], emask[:0]) == 0        # no edges
    assert _port(nbr[:, :0].copy(), ea, eb, emask) == 0      # K = 0
    assert _port(nbr, ea, eb, np.zeros_like(emask)) == 0     # all masked
    # endpoints at the pad row (all sentinel) count nothing
    nbr[16] = 16
    pad = np.full_like(ea, 16)
    assert _port(nbr, pad, eb, emask) == 0


def test_cpu_wrapper_is_the_plain_version():
    nbr, ea, eb, emask = (torch.from_numpy(x)
                          for x in _case(8, 64, 40, 200, True))
    assert int(port.intersect_local(nbr, ea, eb, emask)) == int(
        port.intersect_local_plain(nbr, ea, eb, emask))
