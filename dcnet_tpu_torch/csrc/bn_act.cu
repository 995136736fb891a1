// K7: the eval-mode epilogue of a float convolution in one pass, for Hopper
// (sm_90a):
//
//     out = act(bn(y)) [+ residual]
//
// y (rows, C) contiguous (an NHWC conv output, rows = N H W), in fp32 or
// bf16; bn the BatchNorm on its running statistics, with fp32 mean, var,
// weight, bias (C,) and eps; act none, ReLU or leaky ReLU with the slope
// rounded to y's type; residual (rows, C) of y's type or none (the Darknet
// shortcut that follows the conv). out (rows, C) in y's type.
//
// No TPU kernel: the JAX package leaves this epilogue to XLA's fusion
// (dcnet_tpu/models/darknet.py: conv, BatchNorm, leaky ReLU and the
// shortcut add). Eager PyTorch ran it as five passes over the map, each a
// read and a write of it: the running mean copied and 1 / sqrt(var + eps)
// computed (two small launches), the channels-last BatchNorm transform, the
// leaky ReLU and the add.
//
// Rounding: the passes it replaces, op for op. The affine in fp32 as
// PyTorch's channels-last BatchNorm kernel computes it,
// fma(w * (x - mean), inv, b) with inv = rsqrtf(var + eps) from the running
// variance, rounded to y's type; then the activation on that value in fp32
// (leaky: x > 0 ? x : x * slope; ReLU: max(x, 0), NaN kept), rounded again;
// then the residual added in fp32 and rounded. The intrinsics pin every
// rounding: nvcc contracts no product into a later add but the one that
// PyTorch's kernel contracts. On the card (PyTorch 2.11, CUDA 12.8) that is
// the unfused ops' output bit for bit for bf16 maps of any rank and fp32
// maps of rank 2 and 3; fp32 maps of rank 4 and 5 take another BatchNorm
// there (cuDNN's), up to 5 units of fp32 at the magnitude of the affine's
// terms apart on about a third of the elements.
//
// Bound: bytes. Each element is read once (and its residual once) and
// written once: rows C size(T) (2 or 3 times). The Darknet-53 tick of 120
// frames at 256 px moves about 3.4 GB each way in bf16, 2.0 ms at
// 3.35 TB/s, plus 0.4 ms for the shortcuts' residuals.
//
// Design: a thread owns one 16-byte vector of channels (8 bf16 or 4 fp32;
// single elements where C or a pointer does not allow it) and walks rows
// with a grid stride, two rows an iteration (both loads in flight before
// either store). It reads its channels' four parameters once and keeps
// them in registers, so the parameter reads cost nothing per row. A block
// is lanes x rows threads with lanes = C / vector (at most 256), so a
// warp's loads cover consecutive bytes of consecutive rows. The grid fills
// the card once (the occupancy the compiler allows), capped by the rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2 };

constexpr int kThreads = 256;
constexpr int kRowsPerIter = 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

struct Params {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
  float slope;
  int act;
};

// One element: the affine rounded to T, the activation rounded to T, the
// residual added in fp32 and rounded to T.
template <typename T, bool kRes>
__device__ __forceinline__ T one(float x, float m, float inv, float w, float b, int act,
                                 float slope, T r) {
  const float t = __fmaf_rn(__fmul_rn(w, __fsub_rn(x, m)), inv, b);
  float a = to_float(from_float<T>(t));
  if (act == kLeaky) {
    a = a > 0.0f ? a : __fmul_rn(a, slope);
    a = to_float(from_float<T>(a));
  } else if (act == kRelu) {
    a = isnan(a) ? a : fmaxf(a, 0.0f);
  }
  if constexpr (kRes) {
    return from_float<T>(__fadd_rn(a, to_float(r)));
  } else {
    return from_float<T>(a);
  }
}

template <typename T, int kVec, bool kRes>
__global__ void __launch_bounds__(kThreads) bn_act_kernel(const T* __restrict__ y,
                                                          const T* __restrict__ res,
                                                          T* __restrict__ out, long long rows,
                                                          int lanes, Params p) {
  using P = Pack<T, kVec>;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  float m[kVec], inv[kVec], w[kVec], b[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int c = lane * kVec + e;
    m[e] = p.mean[c];
    inv[e] = rsqrtf(p.var[c] + p.eps);
    w[e] = p.weight[c];
    b[e] = p.bias[c];
  }
  const long long step = (long long)gridDim.y * blockDim.y;
  const P* yv = reinterpret_cast<const P*>(y);
  const P* rv = reinterpret_cast<const P*>(res);
  P* ov = reinterpret_cast<P*>(out);
  for (long long r0 = blockIdx.y * (long long)blockDim.y + threadIdx.y; r0 < rows;
       r0 += kRowsPerIter * step) {
    P xs[kRowsPerIter], rs[kRowsPerIter];
    bool live[kRowsPerIter];
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      const long long r = r0 + j * step;
      live[j] = r < rows;
      if (live[j]) {
        xs[j] = yv[r * lanes + lane];
        if constexpr (kRes) rs[j] = rv[r * lanes + lane];
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      if (!live[j]) continue;
      P o;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        T r{};
        if constexpr (kRes) r = rs[j].v[e];
        o.v[e] = one<T, kRes>(to_float(xs[j].v[e]), m[e], inv[e], w[e], b[e], p.act, p.slope,
                              r);
      }
      ov[(r0 + j * step) * lanes + lane] = o;
    }
  }
}

template <typename T, int kVec, bool kRes>
cudaError_t launch(const void* y, const void* res, void* out, long long rows, int c,
                   const Params& p, cudaStream_t stream) {
  auto kernel = bn_act_kernel<T, kVec, kRes>;
  const int lanes = c / kVec;
  const int bx = std::min(lanes, kThreads);
  const int by = kThreads / bx;
  static int sms = 0, per_sm = 0;  // one card a process, as the other kernels assume
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  const long long gx = (lanes + bx - 1) / bx;
  const long long fill = std::max<long long>(1, (long long)sms * std::max(per_sm, 1) / gx);
  const long long need = (rows + (long long)by * kRowsPerIter - 1) / ((long long)by * kRowsPerIter);
  const long long gy = std::min<long long>({std::max<long long>(need, 1), fill, 65535});
  kernel<<<dim3((unsigned)gx, (unsigned)gy), dim3(bx, by), 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(res), static_cast<T*>(out), rows, lanes, p);
  return cudaGetLastError();
}

template <typename T, int kVec>
cudaError_t launch_res(const void* y, const void* res, void* out, long long rows, int c,
                       const Params& p, cudaStream_t stream) {
  return res ? launch<T, kVec, true>(y, res, out, rows, c, p, stream)
             : launch<T, kVec, false>(y, res, out, rows, c, p, stream);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename T>
cudaError_t dispatch(const void* y, const void* res, void* out, long long rows, int c,
                     const Params& p, cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const bool vec = c % kVec == 0 && aligned16(y) && aligned16(out) && (!res || aligned16(res));
  return vec ? launch_res<T, kVec>(y, res, out, rows, c, p, stream)
             : launch_res<T, 1>(y, res, out, rows, c, p, stream);
}

}  // namespace

extern "C" {

// y, res (or null), out: (rows, c) contiguous of dtype 0 fp32 / 1 bf16;
// mean, var, weight, bias: (c,) fp32; act: 0 none, 1 ReLU, 2 leaky ReLU
// with `slope`. Returns a cudaError_t code; nothing is launched on a
// refused argument.
int dcnet_bn_act(const void* y, const void* res, void* out, const float* mean, const float* var,
                 const float* weight, const float* bias, float eps, float slope, int act,
                 long long rows, int c, int dtype, void* stream) {
  if (rows < 1 || c < 1 || act < kNone || act > kLeaky || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Params p{mean, var, weight, bias, eps, slope, act};
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dispatch<float>(y, res, out, rows, c, p, s)
                          : dispatch<bf16>(y, res, out, rows, c, p, s));
}

const char* dcnet_bn_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
