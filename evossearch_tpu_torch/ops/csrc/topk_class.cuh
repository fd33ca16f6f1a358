// Residue-class selection of the tree kernel's f32 path (B1,
// topk_tree.cu:tree_kernel) on the CUDA cores, as the reference's kernels
// share _tree_reduce_emit (evossearch_tpu/ops/topk_pallas.py:417-517).
// The tensor-core kernel of topk_tc.cuh (B1's bf16 path, B3 and E1) walks
// the same rank order with group_of_rank and the same output layout.
//
// The corpus is cut into tiles of tile_rows rows; residue class j of tile
// t is the rows t*tile_rows + j + 128*g, g < G = tile_rows/128. For every
// (query, tile, class) the selection emits the best two figures with their
// rows and the third-best figure, in the reference's pre-packed layout:
//   cand_s, cand_i: (nq, tiles*256), tile t owning columns
//                   [t*256, t*256+128) = best, [t*256+128, t*256+256) = 2nd
//   m3:             (nq, tiles*128), the class's third-best figure
// The figure is whatever the kernel ranks by: here the exact score; the
// tensor-core kernel also ranks certified upper bounds on it (B3). Rows at
// or past n rank at -FLT_MAX and keep their row number.
//
// The reference reduces each class with a halving tree whose figure-only
// merges prefer the left operand on ties. That tree is a balanced merge
// over the class's groups taken in the order rank(g) = 2*bitrev(g mod G/2)
// + (g >= G/2) (bitrev over log2(G/2) bits), so it keeps the top two under
// (figure desc, rank asc) and the exact third value. The selection walks
// the groups in that order (group_of_rank inverts the formula) with a
// running top-3 and the ordered warp merge of topk_common.cuh, and so gives
// the reference's outputs bit for bit on ties too.
//
// Layout: one thread per (class, quarter of the rank order, 16 queries);
// 4 lanes merge per class, 32 classes per 128-thread block, a tile's 128
// classes over 4 blocks (blockIdx.y = tile * 4 + quarter of the classes),
// blockIdx.x the 16-query chunk.
#pragma once

#include "topk_common.cuh"

namespace evs {

constexpr int CLASSES = 128;
constexpr int CLASS_SEG = 4;                                // lanes per class
constexpr int CLASSES_PER_BLOCK = THREADS / CLASS_SEG;      // 32
constexpr int BLOCKS_PER_TILE = CLASSES / CLASSES_PER_BLOCK;

// The group at rank r of the halving tree's order, half_bits = log2(G/2)
// >= 1: the low bit of r picks the half, the rest is the bit-reversed group.
__device__ __forceinline__ int group_of_rank(int r, int half_bits) {
  const int low = (int)(__brev((unsigned)(r >> 1)) >> (32 - half_bits));
  return ((r & 1) << half_bits) + low;
}

// log2(G/2) for a power-of-two tile of at least 512 rows.
inline int class_half_bits(int tile_rows) {
  int half_bits = 0;
  while ((CLASSES << (half_bits + 1)) < tile_rows) ++half_bits;
  return half_bits;
}

inline dim3 class_grid(int nq, int n, int tile_rows) {
  const int tiles = (n + tile_rows - 1) / tile_rows;
  return dim3((nq + QM - 1) / QM, tiles * BLOCKS_PER_TILE);
}

// The selection of one thread. ``figure(row, acc)`` fills acc[q] with the
// figure of corpus row ``row`` (< n) for the block's QM queries.
template <typename Figure>
__device__ __forceinline__ void class_select(const Figure& figure, int nq,
                                             int n, int tile_rows,
                                             int half_bits,
                                             float* __restrict__ cand_s,
                                             int* __restrict__ cand_i,
                                             float* __restrict__ m3) {
  const int q0 = blockIdx.x * QM;
  const int tile = blockIdx.y / BLOCKS_PER_TILE;
  const int j = (blockIdx.y % BLOCKS_PER_TILE) * CLASSES_PER_BLOCK +
                threadIdx.x / CLASS_SEG;
  const int seg = threadIdx.x % CLASS_SEG;
  const int steps = tile_rows / CLASSES / CLASS_SEG;
  const int base = tile * tile_rows;

  float s[QM][3];
  int ix[QM][3];
  init_state<3>(s, ix);
  for (int t = 0; t < steps; ++t) {
    const int row =
        base + group_of_rank(seg * steps + t, half_bits) * CLASSES + j;
    float acc[QM];
    if (row < n) {
      figure(row, acc);
    } else {
#pragma unroll
      for (int q = 0; q < QM; ++q) acc[q] = NEG_FILL;
    }
#pragma unroll
    for (int q = 0; q < QM; ++q) insert<3>(s[q], ix[q], acc[q], row);
  }
  merge_segments<3, CLASS_SEG>(s, ix);

  if (seg == 0) {
    const size_t tiles = gridDim.y / BLOCKS_PER_TILE;
    const size_t c_cols = tiles * 2 * CLASSES;
    const size_t m_cols = tiles * CLASSES;
#pragma unroll
    for (int q = 0; q < QM; ++q) {
      if (q0 + q < nq) {
        const size_t c =
            (size_t)(q0 + q) * c_cols + (size_t)tile * 2 * CLASSES + j;
        cand_s[c] = s[q][0];
        cand_i[c] = ix[q][0];
        cand_s[c + CLASSES] = s[q][1];
        cand_i[c + CLASSES] = ix[q][1];
        m3[(size_t)(q0 + q) * m_cols + (size_t)tile * CLASSES + j] = s[q][2];
      }
    }
  }
}

}  // namespace evs
