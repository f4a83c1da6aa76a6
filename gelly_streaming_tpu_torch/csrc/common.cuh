// Shared definitions of the port's CUDA kernels, and the readers of the
// two wires a window stack arrives on.
//
// Each csrc/*.cu file builds into its own shared library with a plain C
// interface (gelly_streaming_tpu_torch/kernels.py), bound with ctypes.
// Every entry point takes the device index and PyTorch's current stream,
// launches on that stream without synchronising, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a launch
// the runtime refused.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GS_EXPORT extern "C" __attribute__((visibility("default")))

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kThreads = 256;                    // threads per block
constexpr int kWarpsPerBlock = kThreads / kWarp;

// The name of a CUDA error code an entry point returned. Each library
// (one per source file) carries its own copy.
GS_EXPORT const char* gs_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The two wires a [windows, eb] stack of edge slots arrives on
// (gelly_streaming_tpu_torch/ops/compact_ingress.py). read(w, i, s, d)
// loads slot i of window w into (s, d) and returns whether it holds an
// edge; a slot that does not is padding, whatever its ids.
//
// The standard wire: int32 src and dst, bool valid, 9 bytes a slot.
struct StandardWire {
    const int* src;
    const int* dst;
    const bool* valid;
    int eb;

    __device__ __forceinline__ bool read(int w, int i, int& s,
                                         int& d) const {
        const long long off = (long long)w * eb + i;
        s = src[off];
        d = dst[off];
        return valid[off];
    }
};

// The compact wire: uint16 src and dst, one int32 count of valid slots
// per window, 4 bytes a slot. Padding is each window's suffix, so slot i
// of window w is padding iff i >= nvalid[w]: the decode the TPU kernel
// ran per tile (pallas_window.py:548-576) happens here, at the one load
// of each slot, and no widened int32 stack exists.
struct CompactWire {
    const uint16_t* src;
    const uint16_t* dst;
    const int* nvalid;
    int eb;

    __device__ __forceinline__ bool read(int w, int i, int& s,
                                         int& d) const {
        const long long off = (long long)w * eb + i;
        s = src[off];
        d = dst[off];
        return i < nvalid[w];
    }
};
