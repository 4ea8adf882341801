// Helpers shared by the flash attention kernels (csrc/flash_attention.cu,
// csrc/flash_attention_bwd.cu), on top of mma_common.cuh's cp.async,
// ldmatrix and bf16 mma.sync.m16n8k16 helpers, for sm_90a.
//
// Fragment layouts (m16n8k16): an A fragment (16 x 16, row-major) comes
// from ldsm_x4 at row lane % 16, column (lane / 16) * 8 of its tile; a C
// fragment holds rows lane / 4 (c[0], c[1]) and lane / 4 + 8 (c[2], c[3])
// at columns (lane % 4) * 2 and + 1, so two adjacent C tiles are one A
// fragment of the next product.  A B fragment pair for n-tiles 2j, 2j+1
// comes from ldsm_x4 on an [n][k] tile, or ldsm_x4_trans on a [k][n] one.
#pragma once

#include "mma_common.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// element offset of flattened row r (token r / G, head r % G of the group)
// from the group's first head at token 0, in a [.., Sq, H, width] tensor
__device__ __forceinline__ long long row_offset(int r, int G, int H, int width) {
  return ((long long)(r / G) * H + r % G) * width;
}
}  // namespace
