// cuTensorMapEncodeTiled, reached at run time through the CUDA runtime's
// driver entry point (no -lcuda): the host side of K6's TMA tensor maps
// (conv_s8_tma.cuh, conv_s8_halo.cuh).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace dcnet {

using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, or null where it is not found.
inline TensorMapEncode tensor_map_encoder() {
  static TensorMapEncode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess || fn == nullptr) {
      cudaGetLastError();
      return nullptr;
    }
    encode = reinterpret_cast<TensorMapEncode>(fn);
  }
  return encode;
}

}  // namespace dcnet
