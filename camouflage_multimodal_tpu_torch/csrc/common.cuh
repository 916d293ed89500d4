// Shared by every kernel library of this directory: each .cu builds into its
// own shared library with a plain C interface (loaded through ctypes), so
// each exports its own error-string helper and its own count of the kernels
// it has launched.
#pragma once

#include <cuda_runtime.h>

#define CMT_EXPORT extern "C" __attribute__((visibility("default")))

// Kernels this library has launched since it was loaded (a host counter: a
// caller reads it before and after a call to see how many launches the call
// made).
static long long cmt_launches_ = 0;

// Launchers return cudaGetLastError() right after each launch; the Python
// wrapper raises on a nonzero code and asks for its text here.
#define CMT_DEFINE_ERROR_STRING                                         \
  CMT_EXPORT const char* cmt_error_string(int code) {                 \
    return cudaGetErrorString(static_cast<cudaError_t>(code));        \
  }                                                                     \
  CMT_EXPORT long long cmt_kernel_launches() { return cmt_launches_; }

#define CMT_CHECK_LAUNCH()                                              \
  do {                                                                  \
    cudaError_t err_ = cudaGetLastError();                              \
    if (err_ != cudaSuccess) return static_cast<int>(err_);             \
    ++cmt_launches_;                                                    \
  } while (0)

// Opt a kernel into more than 48 KB of dynamic shared memory when asked.
template <typename Kernel>
inline int cmt_set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
