// Device code of the bf16 co-attention block on Hopper's tensor-core path,
// shared by K1/K2 (coattn.cu) and K4's bf16 rings (coattn_ring.cu): one
// block computes softmax_rows(T * q kv^T) kv for 64 rows of q against a
// whole (P, C) kv frame, C % 128 == 0 and C <= 512. The design notes are in
// coattn.cu; in short:
//
// - 384 threads: warpgroups 0 and 1 compute, warpgroup 2 loads (one thread
//   issues every TMA copy); setmaxnreg moves registers to the computing
//   warpgroups (240 a thread) from the loading one (24).
// - Shared memory holds the 64 x C q tile (loaded once), a ring of two
//   64 x C kv tiles and 2 x 16 KB to exchange partial scores: tiles arrive
//   by TMA (cp.async.bulk.tensor) in boxes of 64 rows x 64 channels (128
//   bytes, 128B swizzle), completion signalled on mbarriers ("full" per
//   stage); the computing threads release a stage on its "empty" mbarrier.
// - The kv tile serves both products: as the K-major B operand of
//   QK^T and as the MN-major (transposed) B operand of PV.
// - Warpgroup w owns channels [w C/2, (w+1) C/2): it takes the partial
//   logits of its channels (wgmma m64n64k16, A and B from shared memory),
//   the two partials are summed through shared memory between two named
//   barriers, both warpgroups run the online softmax on the full 64 x 64
//   tile in registers (fp32, identical in both), round the weights
//   exp(s - m) to bf16 and add P kv[:, own channels] into their own 64 x C/2
//   fp32 accumulator in registers (wgmma m64n(C/2)k16, A = P from
//   registers). Each row is divided by its sum once, at the end.
// - Ragged P and row windows: TMA zero-fills rows past P, logit columns
//   past the kv frame's P are -inf, rows past the q window are not stored.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dcnet {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;        // q rows of a block, and kv rows of a tile
constexpr int kBox = 64;         // channels of one TMA box: 128 bytes of bf16
constexpr int kBoxBytes = kRows * kBox * 2;  // 8 KB, 1024-byte aligned in smem
constexpr int kThreads = 384;
constexpr int kStages = 2;
constexpr int kXchFloats = 64 * 64;          // one warpgroup's partial scores
constexpr float kLog2e = 1.4426950408889634f;

// The shapes this block takes: bf16, C a multiple of 128 up to 512 (each
// warpgroup's C/2 channels are whole 64-channel boxes; its accumulator is
// C/4 registers a thread).
__host__ __device__ inline bool takes(int C) {
  return C % 128 == 0 && C >= 128 && C <= 512;
}

// Dynamic shared memory of a block: q, two kv stages, the exchange, five
// mbarriers, and 1 KB to align the tiles to the 128B swizzle's 1024 bytes.
__host__ __device__ inline size_t smem_bytes(int C) {
  return (size_t)C * kRows * 2 * (1 + kStages) + 2 * kXchFloats * 4 + 64 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// A shared-memory matrix descriptor with the 128B swizzle: start address,
// leading and stride byte offsets (16-byte units). K-major tiles ignore the
// leading offset; MN-major tiles step to the next 64 columns by it.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence, commit or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64, fp32) = (scale_d ? d : 0) + A B, A and B bf16 in shared memory
// (descriptors), both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) += A B, A (64 x 16 bf16) from registers in the
// accumulator-row layout, B (16 x 64 bf16) in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, fp32) += A B, A (64 x 16 bf16) from registers in the
// accumulator-row layout, B (16 x 128 bf16) in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 192, fp32) += A B, A (64 x 16 bf16) from registers in the
// accumulator-row layout, B (16 x 192 bf16) in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n192(float (&d)[96], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 256, fp32) += A B, A (64 x 16 bf16) from registers in the
// accumulator-row layout, B (16 x 256 bf16) in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// o (64 x N) += P B for the warpgroup's N = C/2 channels.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 64) {
    wgmma_rs_m64n64(o, a, desc_b);
  } else if constexpr (N == 128) {
    wgmma_rs_m64n128(o, a, desc_b);
  } else if constexpr (N == 192) {
    wgmma_rs_m64n192(o, a, desc_b);
  } else {
    wgmma_rs_m64n256(o, a, desc_b);
  }
}

// Where a block's q rows and kv tiles lie in their tensor maps: the
// coordinates after (channel, row), one for a (C, P, B) map (Rank 3: z = b),
// two for a (C, P, S, B) ring (Rank 4: z = slot, w = b).
struct Frame {
  int z, w;
};

template <int Rank>
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int row, Frame f) {
  if constexpr (Rank == 3) {
    tma_load(dst, map, bar, c, row, f.z);
  } else {
    tma_load(dst, map, bar, c, row, f.z, f.w);
  }
}

// Quad reductions: the four threads of a quad hold one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The block's whole computation for rows row0..row0+63 of a row window of
// the q frame (its rows qoff..qoff+Pq-1) against every row of the kv frame
// (P rows; both bf16 frames of their maps), written to the (Pq, C) frame
// `ob` (row stride C). 384 threads; `temperature` scales the logits. The q
// box is read at row qoff + row0: rows past the window (another rank's, or
// TMA's zero fill past the frame) are computed and never stored. K4 passes
// qoff = 0, Pq = P.
//
// Accumulator layout of wgmma m64nN (fp32): thread t of a warpgroup holds
// rows r = 16 (t / 32) + (t % 32) / 4 and r + 8; for each 8-column group
// n8, registers 4 n8 + {0, 1} are row r, columns 8 n8 + 2 (t % 4) + {0, 1},
// and 4 n8 + {2, 3} the same columns of row r + 8. The A operand of
// m64nNk16 from registers has that layout for 16 columns, so the scores of
// kv rows 16 k..16 k+15 are registers 8 k..8 k+7, packed to bf16 pairs.
template <int C, int Rank>
__device__ __forceinline__ void attend_rows(const CUtensorMap* map_q, Frame fq,
                                            const CUtensorMap* map_kv, Frame fkv,
                                            bf16* ob, int row0, int qoff, int Pq,
                                            int P, float temperature,
                                            unsigned char* smem_raw) {
  static_assert(C % 128 == 0 && C <= 512, "the wgmma block takes C % 128 == 0, C <= 512");
  constexpr uint32_t kTileBytes = C * kRows * 2;
  constexpr int kBoxes = C / kBox;
  constexpr int NW = C / 2;        // channels of one computing warpgroup
  constexpr int kOwnBoxes = NW / kBox;

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t q_s = raw + pad;
  const uint32_t kv_s = q_s + kTileBytes;  // stage s at kv_s + s * kTileBytes
  float* xch = reinterpret_cast<float*>(smem_raw + pad + (1 + kStages) * kTileBytes);
  const uint32_t bars = smem_u32(xch + 2 * kXchFloats);
  const uint32_t q_full = bars;             // then full[kStages], empty[kStages]

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8u * (1 + s), 1);
      mbar_init(bars + 8u * (1 + kStages + s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = (P + kRows - 1) / kRows;

  if (tid >= 256) {
    // --- the loading warpgroup: one thread issues every copy ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 256) {
      mbar_expect_tx(q_full, kTileBytes);
      for (int j = 0; j < kBoxes; ++j) {
        load_box<Rank>(q_s + j * kBoxBytes, map_q, q_full, j * kBox, qoff + row0, fq);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        const uint32_t full = bars + 8u * (1 + s);
        mbar_wait(bars + 8u * (1 + kStages + s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, kTileBytes);
        const uint32_t dst = kv_s + s * kTileBytes;
        for (int j = 0; j < kBoxes; ++j) {
          load_box<Rank>(dst + j * kBoxBytes, map_kv, full, j * kBox, it * kRows, fkv);
        }
      }
    }
  } else {
    // --- the two computing warpgroups ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = tid / 128, t = tid % 128, lane = t % 32;
    float o[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const float scale = temperature * kLog2e;  // logits in the log2 domain
    float4* x_mine = reinterpret_cast<float4*>(xch + w * kXchFloats);
    const float4* x_other = reinterpret_cast<const float4*>(xch + (1 - w) * kXchFloats);
    const uint32_t own = w * kOwnBoxes * kBoxBytes;  // own channels' first box
    const uint64_t dq = make_desc(q_s + own, 16, 1024);
    mbar_wait(q_full, 0);

    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages;
      const uint32_t kv = kv_s + s * kTileBytes;
      // K-major for QK^T: 8-row groups 1024 bytes apart; MN-major for PV:
      // 64-channel boxes kBoxBytes apart, 8-row groups 1024 bytes apart
      const uint64_t dk = make_desc(kv + own, 16, 1024);
      const uint64_t dv = make_desc(kv + own, kBoxBytes, 1024);
      mbar_wait(bars + 8u * (1 + s), (it / kStages) & 1);

      // partial logits over own channels: 64 x 64, k-steps of 16 channels
      // (32 bytes inside a 128-byte swizzled row, then the next box)
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NW / 16; ++ks) {
        const uint32_t off = ((ks / 4) * kBoxBytes + (ks % 4) * 32) >> 4;
        wgmma_ss_m64n64(sc, dq + off, dk + off, ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // the two warpgroups' partials; a sum of two is the same in either
      // order, so both warpgroups hold the same logits
      named_barrier(1);  // the other warpgroup has read my last partial
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x_mine[i * 128 + t] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                                          sc[4 * i + 3]);
      }
      named_barrier(2);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = x_other[i * 128 + t];
        sc[4 * i] += v.x;
        sc[4 * i + 1] += v.y;
        sc[4 * i + 2] += v.z;
        sc[4 * i + 3] += v.w;
      }

      // online softmax; this thread's rows r (registers 4 n8 + {0, 1}) and
      // r + 8 (4 n8 + {2, 3}); columns past P get -inf
      const int col0 = it * kRows + (lane & 3) * 2;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = sc[4 * n8 + j] * scale;
          sc[4 * n8 + j] = col0 + n8 * 8 + (j & 1) < P ? v : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * n8], sc[4 * n8 + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * n8 + 2], sc[4 * n8 + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));  // finite: column it*64 < P
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);  // 0 at first
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        sc[4 * n8] = exp2f(sc[4 * n8] - mn0);
        sc[4 * n8 + 1] = exp2f(sc[4 * n8 + 1] - mn0);
        sc[4 * n8 + 2] = exp2f(sc[4 * n8 + 2] - mn1);
        sc[4 * n8 + 3] = exp2f(sc[4 * n8 + 3] - mn1);
        sum0 += sc[4 * n8] + sc[4 * n8 + 1];
        sum1 += sc[4 * n8 + 2] + sc[4 * n8 + 3];
      }
      l0 = l0 * alpha0 + quad_sum(sum0);
      l1 = l1 * alpha1 + quad_sum(sum1);
#pragma unroll
      for (int n8 = 0; n8 < NW / 8; ++n8) {
        o[4 * n8] *= alpha0;
        o[4 * n8 + 1] *= alpha0;
        o[4 * n8 + 2] *= alpha1;
        o[4 * n8 + 3] *= alpha1;
      }
      uint32_t pa[4][4];  // the weights rounded to bf16, as A fragments
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[k][i] = pack_bf16(sc[8 * k + 2 * i], sc[8 * k + 2 * i + 1]);
      }

      // o += P kv[:, own channels]: k-steps of 16 kv rows (2048 bytes)
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_pv<NW>(o, pa[k], dv + ((k * 16 * 128) >> 4));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(bars + 8u * (1 + kStages + s));  // this stage may be refilled
    }

    // each row divided by its sum once; rows past the window are not stored
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r = row0 + 16 * (t / 32) + lane / 4;
    bf16* dst = ob + (long long)r * C + w * NW + (lane & 3) * 2;
#pragma unroll
    for (int n8 = 0; n8 < NW / 8; ++n8) {
      if (r < Pq) {
        *reinterpret_cast<uint32_t*>(dst + n8 * 8) =
            pack_bf16(o[4 * n8] * inv0, o[4 * n8 + 1] * inv0);
      }
      if (r + 8 < Pq) {
        *reinterpret_cast<uint32_t*>(dst + 8 * C + n8 * 8) =
            pack_bf16(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
      }
    }
  }
}

// --- host side ---------------------------------------------------------------

// A tensor map of `rank` (3 or 4) over a tensor whose innermost dimension
// (C channels) is contiguous: dims innermost first, strides in bytes of
// dims 1..rank-1; boxes of 64 rows x `box_c` elements of `type` (128 bytes:
// 64 bf16 by default, 128 for the int8 block's UINT8), 128B swizzle, zero
// fill out of bounds. cuTensorMapEncodeTiled is reached through the
// runtime's driver entry point (no -lcuda). Returns a cudaError_t code.
inline int encode_map(CUtensorMap* map, const void* base, int rank,
                      const uint64_t* dims, const uint64_t* strides,
                      CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      uint32_t box_c = kBox) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess || fn == nullptr) {
      cudaGetLastError();
      return (int)cudaErrorNotSupported;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  cuuint64_t d[4], st[3];
  cuuint32_t box[4] = {box_c, kRows, 1, 1}, elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) d[i] = dims[i];
  for (int i = 0; i < rank - 1; ++i) st[i] = strides[i];
  const CUresult r = encode(map, type, rank,
                            const_cast<void*>(base), d, st, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace dcnet
