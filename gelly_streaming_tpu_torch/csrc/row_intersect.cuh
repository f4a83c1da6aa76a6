// The row intersection shared by the window counter's last stage
// (csrc/window_counter.cu) and the intersect kernel's sorted form
// (csrc/intersect.cu): |A ∩ B| of two ascending rows by a merge, la + lb
// steps at most, in place of the TPU kernel's la × lb compare block
// (gelly_streaming_tpu/ops/pallas_intersect.py `tile_intersect_count`).
#pragma once

#include <climits>

// Row A is read from ra[0, la), row B from rb[0, lb). Each is strictly
// ascending up to its first entry that is not above its predecessor or
// is >= sentinel; the row ends there. The window counter's rows end
// either at their length or at a tail of zeros (the places of removed
// duplicates); a padded table's sorted rows end at their sentinel fill.
template <class T>
__device__ __forceinline__ int merge_count(const T* __restrict__ ra, int la,
                                           const T* __restrict__ rb, int lb,
                                           int sentinel) {
    int i = 0, j = 0, hits = 0, pa = INT_MIN, pb = INT_MIN;
    while (i < la && j < lb) {
        const int x = ra[i], y = rb[j];
        if (x <= pa || y <= pb || x >= sentinel || y >= sentinel) break;
        hits += x == y;
        if (x <= y) {
            pa = x;
            ++i;
        }
        if (y <= x) {
            pb = y;
            ++j;
        }
    }
    return hits;
}
