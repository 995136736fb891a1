// K6, the int8 convolution, for fp32 x, quantized on load: the library
// kernels/conv_s8.py loads for that input type, with the halo route
// (conv_s8_halo.cuh), the gather route and the quantize pass
// (conv_s8.cuh). The kernels, their notes (what they compute, their
// bounds, their designs) and the C entries' arguments are in those
// headers.
#include "conv_s8_halo.cuh"

extern "C" {

int dcnet_conv_s8(const void* x, int x_dtype, int qmode, float in_inv,
                  const void* in_scale, const void* w, void* out, const void* scale,
                  const void* bias, const void* scale2, const void* bias2,
                  const void* addend, long long addend_hw, long long addend_rep,
                  float inv_next, int n, int h, int wd, int ci, int co, int k,
                  int stride, int pad, int mode, int act, int vec, void* stream) {
  return conv_s8_entry<float>(x, x_dtype, qmode, in_inv, in_scale, w, out, scale, bias,
                         scale2, bias2, addend, addend_hw, addend_rep, inv_next, n, h,
                         wd, ci, co, k, stride, pad, mode, act, vec, stream);
}

int dcnet_conv_s8_quant(const void* x, int x_dtype, int qmode, float in_inv,
                        const void* in_scale, void* out, long long rows, int ci, int cp,
                        void* stream) {
  return quant_pass_entry<float>(x, x_dtype, qmode, in_inv, in_scale, out, rows, ci, cp,
                              stream);
}

int dcnet_conv_s8_halo(const void* x, int x_dtype, int qmode, float in_inv,
                       const void* in_scale, const void* w, void* out, const void* scale,
                       const void* bias, const void* scale2, const void* bias2,
                       const void* addend, long long addend_hw, long long addend_rep,
                       float inv_next, int mode, int act, const long long* plan,
                       void* stream) {
  return conv_s8_halo_entry<float>(x, x_dtype, qmode, in_inv, in_scale, w, out, scale, bias,
                                  scale2, bias2, addend, addend_hw, addend_rep, inv_next, mode,
                                  act, plan, stream);
}

const char* dcnet_conv_s8_error_string(int code) { return conv_s8_error_string(code); }

}  // extern "C"
