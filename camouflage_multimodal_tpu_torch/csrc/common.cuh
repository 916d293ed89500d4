// Shared by every kernel library of this directory: each .cu builds into its
// own shared library with a plain C interface (loaded through ctypes), so
// each exports its own error-string helper.
#pragma once

#include <cuda_runtime.h>

#define CMT_EXPORT extern "C" __attribute__((visibility("default")))

// Launchers return cudaGetLastError() right after each launch; the Python
// wrapper raises on a nonzero code and asks for its text here.
#define CMT_DEFINE_ERROR_STRING                                         \
  CMT_EXPORT const char* cmt_error_string(int code) {                 \
    return cudaGetErrorString(static_cast<cudaError_t>(code));        \
  }

#define CMT_CHECK_LAUNCH()                                              \
  do {                                                                  \
    cudaError_t err_ = cudaGetLastError();                              \
    if (err_ != cudaSuccess) return static_cast<int>(err_);             \
  } while (0)

// Opt a kernel into more than 48 KB of dynamic shared memory when asked.
template <typename Kernel>
inline int cmt_set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
