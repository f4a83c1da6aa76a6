"""The numpy host tier of the driver's carried snapshot analytics: its
"host" snapshot tier, and the exact refold of a chunk whose delta wire
overflowed.

Port of the JAX package's `ops/host_snapshot.py` (:36-107), with the
carried min-label fixpoint of ops/host_summary.py (a copy of that
package's `_fixpoint`). The contract is native.snapshot_windows': window
w is the [offsets[w], offsets[w+1]) slice of the flat edge arrays; the
carries deg [vb], cc [vb] and cov [2·vb] are the driver's host-mirror
layouts ((-) at vb + v), int32, updated in place; the result is
{"deg": [W, vb], "labels": [W, vb], "cover": [W, 2·vb]} int32 for the
analytics given. The fixpoint converges to the canonical labeling
(each slot labelled with the smallest slot of its set), so this tier,
the C++ one and the card's give the same bits.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .host_summary import fixpoint


def snapshot_windows(src: np.ndarray, dst: np.ndarray,
                     offsets: np.ndarray, vb: int,
                     deg: Optional[np.ndarray] = None,
                     cc: Optional[np.ndarray] = None,
                     cov: Optional[np.ndarray] = None
                     ) -> Dict[str, np.ndarray]:
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    num_w = len(offsets) - 1
    if num_w < 0 or int(offsets[-1]) != len(src):
        raise ValueError("offsets must span the flat edge arrays")
    for name, a, ln in (("deg", deg, vb), ("cc", cc, vb),
                        ("cov", cov, 2 * vb)):
        if a is not None and (a.dtype != np.int32 or len(a) != ln):
            raise ValueError("carried %s must be int32[%d]" % (name, ln))
    od = np.empty((num_w, vb), np.int32) if deg is not None else None
    oc = np.empty((num_w, vb), np.int32) if cc is not None else None
    ov = np.empty((num_w, 2 * vb), np.int32) if cov is not None else None
    for w in range(num_w):
        lo, hi = int(offsets[w]), int(offsets[w + 1])
        s, d = src[lo:hi], dst[lo:hi]
        if deg is not None:
            np.add.at(deg, s, 1)
            np.add.at(deg, d, 1)
            od[w] = deg
        if cc is not None:
            cc[:] = fixpoint(cc, s, d)
            oc[w] = cc
        if cov is not None:
            cov[:] = fixpoint(cov, np.concatenate([s, s + vb]),
                              np.concatenate([d + vb, d]))
            ov[w] = cov
    return {k: a for k, a in (("deg", od), ("labels", oc), ("cover", ov))
            if a is not None}
