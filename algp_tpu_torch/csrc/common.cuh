// Shared helpers of the algp_tpu_torch kernels (plain C interface,
// loaded with ctypes by ops/_cuda.py).
#pragma once

#include <cuda_runtime.h>

#define ALGP_EXPORT extern "C" __attribute__((visibility("default")))

// Every launcher returns cudaGetLastError() right after its launches, so
// a refused launch (bad grid, too much shared memory) is reported to the
// Python wrapper, which raises.
static inline int algp_last_error() { return static_cast<int>(cudaGetLastError()); }
