// Shared device code of the CUDA-core candidate kernels (the f32 paths of
// topk_block.cu and topk_tree.cu): a per-thread dot product of one corpus
// row against a register tile of QM queries, a running top-LEV insertion
// (also B2's tensor-core selection), and a warp merge of those running
// states.
//
// Both kernels select per "slot" (a 256-row block, or one residue class of
// a tile) over a sequence of rows given in a fixed order. A thread keeps,
// for each of its QM queries, the top-LEV scores of the rows it has seen,
// ties going to the row seen first (strict ">" on insertion). A slot's
// rows are split into SEG contiguous runs of that order, one run per lane
// of SEG neighbouring lanes; the runs' states then merge pairwise, the
// earlier run always on the left, so the merged state is exactly the
// top-LEV of the whole sequence under (score desc, order asc).
#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace evs {

constexpr int QM = 16;                  // queries per thread and per block
constexpr int THREADS = 128;            // threads per block
constexpr float NEG_FILL = -FLT_MAX;    // score of padded / tail rows
constexpr unsigned FULL_MASK = 0xffffffffu;

// Eight consecutive row elements.
__device__ __forceinline__ void load_row_vec(const float* p, float (&r)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

// acc[q] = <row, query q> for the block's QM queries, held in shared
// memory as qs[k * QM + q] (f32). IEEE f32 FMA on the CUDA cores: no TF32.
// d must be a multiple of 8.
__device__ __forceinline__ void dot_row(const float* __restrict__ row,
                                        const float* __restrict__ qs, int d,
                                        float (&acc)[QM]) {
  constexpr int W = 8;  // elements per load_row_vec
#pragma unroll
  for (int q = 0; q < QM; ++q) acc[q] = 0.f;
  for (int k0 = 0; k0 < d; k0 += W) {
    float r[W];
    load_row_vec(row + k0, r);
#pragma unroll
    for (int kk = 0; kk < W; ++kk) {
      const float4* qv = reinterpret_cast<const float4*>(qs + (k0 + kk) * QM);
#pragma unroll
      for (int j = 0; j < QM / 4; ++j) {
        const float4 v = qv[j];
        acc[4 * j + 0] = fmaf(r[kk], v.x, acc[4 * j + 0]);
        acc[4 * j + 1] = fmaf(r[kk], v.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(r[kk], v.z, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(r[kk], v.w, acc[4 * j + 3]);
      }
    }
  }
}

// Insert (v, i) into a descending top-LEV list; an equal score already in
// the list stays ahead of the newcomer. Slots start at -inf, so the first
// LEV rows always enter, NEG_FILL padding included.
template <int LEV>
__device__ __forceinline__ void insert(float (&s)[LEV], int (&ix)[LEV],
                                       float v, int i) {
#pragma unroll
  for (int j = LEV - 1; j > 0; --j) {
    const bool up = v > s[j - 1];
    const bool here = v > s[j];
    s[j] = up ? s[j - 1] : (here ? v : s[j]);
    ix[j] = up ? ix[j - 1] : (here ? i : ix[j]);
  }
  if (v > s[0]) {
    s[0] = v;
    ix[0] = i;
  }
}

// Merge the states of SEG neighbouring lanes (one slot) into the lane with
// seg == 0: at each level the lane seg (a multiple of 2*off) takes in the
// list of lane seg+off, whose rows all come later in the slot's order, by
// inserting that list best-first. Lanes that are not receivers compute
// states nobody reads again, so no lane is masked off.
template <int LEV, int SEG>
__device__ __forceinline__ void merge_segments(float (&s)[QM][LEV],
                                               int (&ix)[QM][LEV]) {
#pragma unroll
  for (int off = 1; off < SEG; off <<= 1) {
#pragma unroll
    for (int q = 0; q < QM; ++q) {
      float bs[LEV];
      int bi[LEV];
#pragma unroll
      for (int j = 0; j < LEV; ++j) {
        bs[j] = __shfl_down_sync(FULL_MASK, s[q][j], off);
        bi[j] = __shfl_down_sync(FULL_MASK, ix[q][j], off);
      }
#pragma unroll
      for (int j = 0; j < LEV; ++j) insert<LEV>(s[q], ix[q], bs[j], bi[j]);
    }
  }
}

// Block's query chunk into shared memory, transposed to qs[k * QM + q];
// queries past nq are zero (their scores are computed and never written).
__device__ __forceinline__ void load_queries(const float* __restrict__ q_in,
                                             int nq, int d, int q0,
                                             float* qs) {
  for (int t = threadIdx.x; t < QM * d; t += blockDim.x) {
    const int qi = t / d;
    const int k = t - qi * d;
    qs[k * QM + qi] = (q0 + qi < nq) ? q_in[(size_t)(q0 + qi) * d + k] : 0.f;
  }
  __syncthreads();
}

template <int LEV>
__device__ __forceinline__ void init_state(float (&s)[QM][LEV],
                                           int (&ix)[QM][LEV]) {
#pragma unroll
  for (int q = 0; q < QM; ++q) {
#pragma unroll
    for (int j = 0; j < LEV; ++j) {
      s[q][j] = -INFINITY;
      ix[q][j] = -1;
    }
  }
}

// Score one row (or NEG_FILL past the corpus end) and insert it into
// every query's list.
template <int LEV>
__device__ __forceinline__ void visit_row(const float* __restrict__ emb, int n,
                                          int d, const float* qs, int row,
                                          float (&s)[QM][LEV],
                                          int (&ix)[QM][LEV]) {
  float acc[QM];
  if (row < n) {
    dot_row(emb + (size_t)row * d, qs, d, acc);
  } else {
#pragma unroll
    for (int q = 0; q < QM; ++q) acc[q] = NEG_FILL;
  }
#pragma unroll
  for (int q = 0; q < QM; ++q) insert<LEV>(s[q], ix[q], acc[q], row);
}

inline int set_smem(const void* kernel, int bytes) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace evs
