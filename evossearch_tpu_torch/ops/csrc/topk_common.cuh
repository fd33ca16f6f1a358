// Shared device code of the candidate kernels: the fill score of rows past
// the corpus, a running top-LEV insertion (the block walk's selection,
// topk_block.cu) and the opt-in to more than 48 KB of dynamic shared
// memory.
#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace evs {

constexpr float NEG_FILL = -FLT_MAX;    // score of padded / tail rows
constexpr unsigned FULL_MASK = 0xffffffffu;

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

inline int set_smem(const void* kernel, int bytes) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace evs
