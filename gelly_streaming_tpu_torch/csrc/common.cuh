// Shared definitions of the port's CUDA kernels.
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
