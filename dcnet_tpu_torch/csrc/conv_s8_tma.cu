// K6, the int8 convolution, on its main route: wgmma s8 on TMA tiles, the
// library kernels/conv_s8.py loads for every shape conv_plan gives that
// route (int8 x, or the int8 copy the quantize pass of conv_s8.cuh writes).
// The kernel, its note (bound, design) and the entry's plan are in
// conv_s8_tma.cuh.
#include "conv_s8_tma.cuh"

extern "C" {

int dcnet_conv_s8_tma(const void* xq, const void* w, void* out, const void* scale,
                      const void* bias, const void* scale2, const void* bias2,
                      const void* addend, long long addend_hw, long long addend_rep,
                      float inv_next, int mode, int act, const long long* plan,
                      void* stream) {
  return conv_s8_tma_entry(xq, w, out, scale, bias, scale2, bias2, addend, addend_hw,
                           addend_rep, inv_next, mode, act, plan, stream);
}

const char* dcnet_conv_s8_tma_error_string(int code) {
  switch (code) {
    case kErrPlan:
      return "the plan's numbers are out of range";
    case kErrMapA:
      return "the CUDA driver refused a tensor map of x (cuTensorMapEncodeTiled)";
    case kErrMapB:
      return "the CUDA driver refused the tensor map of w (cuTensorMapEncodeTiled)";
    case kErrEncoder:
      return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
