// Which co-attention block a launch of K1, K2 (coattn.cu) or K4
// (coattn_ring.cu) takes: a rule of the input dtype and the width C alone,
// applied by the C entry points, never as a fallback. Every C >= 1 has a
// block.
//
//   bf16,  C % 128 == 0, C <= 512  wgmma + TMA       attend_wgmma.cuh
//   bf16,  other C % 16 == 0, C <= 672 (its smem)  WMMA  attend_tile.cuh
//   fp32,  C % 16 == 0, C <= 512   3xTF32            attend_tf32.cuh
//   int8,  C % 128 == 0, C <= 512  wgmma s8 + TMA    attend_s8.cuh
//   every other width and dtype    the general block attend_wide.cuh
//
// Every configuration the repository runs (C = 512, 256 on the locks) takes
// one of the tensor-core blocks.
#pragma once

#include "attend_s8.cuh"
#include "attend_tf32.cuh"
#include "attend_tile.cuh"
#include "attend_wgmma.cuh"
#include "attend_wide.cuh"

namespace dcnet {

// Block codes, as dcnet_coattn_block reports them (kernels/coattn.py's
// attend_body names them "block", "wgmma", "tf32x3", "wide", "wgmma_s8").
enum BlockCode { kBlockTile = 0, kBlockWgmma = 1, kBlockTf32 = 2, kBlockWide = 3,
                 kBlockS8 = 4 };

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (K4's rings); -1 for a dtype
// no kernel takes or C < 1.
inline int choose_block(int dtype, int C) {
  if (C < 1) return -1;
  switch (dtype) {
    case 0: return tf32::takes(C) ? kBlockTf32 : kBlockWide;
    case 1: return wg::takes(C) ? kBlockWgmma : tile_takes(C) ? kBlockTile : kBlockWide;
    case 2: return s8::takes(C) ? kBlockS8 : kBlockWide;
    default: return -1;
  }
}

}  // namespace dcnet
