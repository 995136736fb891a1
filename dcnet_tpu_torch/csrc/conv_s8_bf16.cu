// K6, the int8 convolution, for bf16 x, quantized on load: the library
// kernels/conv_s8.py loads for that input type. The kernel, its note (what
// it computes, its bound, its design) and the C entry's arguments are in
// conv_s8.cuh.
#include "conv_s8.cuh"

extern "C" {

int dcnet_conv_s8(const void* x, int x_dtype, int qmode, float in_inv,
                  const void* in_scale, const void* w, void* out, const void* scale,
                  const void* bias, const void* scale2, const void* bias2,
                  const void* addend, long long addend_hw, long long addend_rep,
                  float inv_next, int n, int h, int wd, int ci, int co, int k,
                  int stride, int pad, int mode, int act, int vec, void* stream) {
  return conv_s8_entry<bf16>(x, x_dtype, qmode, in_inv, in_scale, w, out, scale, bias,
                         scale2, bias2, addend, addend_hw, addend_rep, inv_next, n, h,
                         wd, ci, co, k, stride, pad, mode, act, vec, stream);
}

int dcnet_conv_s8_quant(const void* x, int x_dtype, int qmode, float in_inv,
                        const void* in_scale, void* out, long long rows, int ci, int cp,
                        void* stream) {
  return quant_pass_entry<bf16>(x, x_dtype, qmode, in_inv, in_scale, out, rows, ci, cp,
                              stream);
}

const char* dcnet_conv_s8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
