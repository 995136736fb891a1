// The shared-memory limit of a block on the H100 and the host-side check
// every launch with dynamic shared memory makes before it asks the runtime
// (the co-attention blocks, K3's passes and K5).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace dcnet {

// Shared memory a block may use on the H100 (227 KB); the launches refuse
// a layout past it before asking the runtime.
constexpr size_t kSmemLimit = 232448;

// Host side, before a launch of `kernel` with `bytes` of dynamic shared
// memory: refuses a layout past kSmemLimit, then raises the kernel's limit
// to `bytes`. Returns a cudaError_t code, 0 on success; a refused attribute
// is cleared, so PyTorch's next error check does not see it.
template <typename K>
inline int prepare_smem(K* kernel, size_t bytes) {
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return 0;
}

}  // namespace dcnet
