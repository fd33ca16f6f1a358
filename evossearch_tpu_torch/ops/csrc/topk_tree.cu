// Residue-class candidate kernel (kernel B1 of the port).
//
// Replaces: evossearch_tpu/ops/topk_pallas.py:_tree_candidates (:579 ->
// _candidates_call :606, pallas_call :635; body _make_tree_kernel :520
// and the halving tree _tree_reduce_emit :417-517), the selection pass of
// fused_topk_batch_tree (:724).
//
// The corpus is cut into tiles of tile_rows rows; residue class j of tile
// t is the rows t*tile_rows + j + 128*g, g < G = tile_rows/128. For every
// (query, tile, class) the kernel emits the best two scores with their
// rows and the third-best score, in the reference's pre-packed layout:
//   cand_s, cand_i: (nq, tiles*256), tile t owning columns
//                   [t*256, t*256+128) = best, [t*256+128, t*256+256) = 2nd
//   m3:             (nq, tiles*128), the class's third-best score
// Rows at or past n score -FLT_MAX and keep their row number.
//
// The reference reduces each class with a halving tree whose score-only
// merges prefer the left operand on ties. That tree is a balanced merge
// over the class's groups taken in the order rank(g) = 2*bitrev(g mod G/2)
// + (g >= G/2) (bitrev over log2(G/2) bits), so it keeps the top two under
// (score desc, rank asc) and the exact third value. The kernel walks the
// groups in that order (group_of_rank inverts the formula) with the same
// running top-3 and ordered warp merge as the block kernel, and so gives
// the reference's outputs bit for bit on ties too.
//
// Design: one thread per (class, quarter of the rank order, 16 queries);
// 4 lanes merge per class, 32 classes per 128-thread block.
// What bounds it on an H100: as the block kernel, 2*Q*N*d f32 FMAs on the
// CUDA cores against one read of the corpus.
// Its times on the card beside the bound: PERF.md (from chip_smoke.py).
// What this simple design leaves on the table: no tensor cores, no staging
// of rows through shared memory, the corpus is read once per 16-query
// chunk, and a tile's 128 classes are spread over 4 blocks that each read
// a quarter of every 128-row group.

#include "topk_common.cuh"

namespace {

constexpr int CLASSES = 128;
constexpr int SEG = 4;                                  // lanes per class
constexpr int CLASSES_PER_BLOCK = evs::THREADS / SEG;   // 32
constexpr int BLOCKS_PER_TILE = CLASSES / CLASSES_PER_BLOCK;

// The group at rank r of the halving tree's order, half_bits = log2(G/2):
// the low bit of r picks the half, the rest is the bit-reversed group.
__device__ __forceinline__ int group_of_rank(int r, int half_bits) {
  const int low = (int)(__brev((unsigned)(r >> 1)) >> (32 - half_bits));
  return ((r & 1) << half_bits) + low;
}

template <typename T>
__global__ void __launch_bounds__(evs::THREADS)
tree_kernel(const T* __restrict__ emb, const float* __restrict__ q_in, int nq,
            int n, int d, int tile_rows, int half_bits,
            float* __restrict__ cand_s, int* __restrict__ cand_i,
            float* __restrict__ m3) {
  extern __shared__ float qs[];
  const int q0 = blockIdx.x * evs::QM;
  evs::load_queries(q_in, nq, d, q0, qs);

  const int tile = blockIdx.y / BLOCKS_PER_TILE;
  const int j = (blockIdx.y % BLOCKS_PER_TILE) * CLASSES_PER_BLOCK +
                threadIdx.x / SEG;
  const int seg = threadIdx.x % SEG;
  const int steps = tile_rows / CLASSES / SEG;
  const int base = tile * tile_rows;

  float s[evs::QM][3];
  int ix[evs::QM][3];
  evs::init_state<3>(s, ix);
  for (int t = 0; t < steps; ++t) {
    const int g = group_of_rank(seg * steps + t, half_bits);
    evs::visit_row<T, 3>(emb, n, d, qs, base + g * CLASSES + j, s, ix);
  }
  evs::merge_segments<3, SEG>(s, ix);

  if (seg == 0) {
    const size_t tiles = gridDim.y / BLOCKS_PER_TILE;
    const size_t c_cols = tiles * 2 * CLASSES;
    const size_t m_cols = tiles * CLASSES;
#pragma unroll
    for (int q = 0; q < evs::QM; ++q) {
      if (q0 + q < nq) {
        const size_t c = (size_t)(q0 + q) * c_cols + (size_t)tile * 2 * CLASSES + j;
        cand_s[c] = s[q][0];
        cand_i[c] = ix[q][0];
        cand_s[c + CLASSES] = s[q][1];
        cand_i[c + CLASSES] = ix[q][1];
        m3[(size_t)(q0 + q) * m_cols + (size_t)tile * CLASSES + j] = s[q][2];
      }
    }
  }
}

template <typename T>
int launch(const void* emb, const float* q, int nq, int n, int d,
           int tile_rows, float* cand_s, int* cand_i, float* m3,
           cudaStream_t stream) {
  const int smem = evs::QM * d * (int)sizeof(float);
  const int err = evs::set_smem((const void*)tree_kernel<T>, smem);
  if (err) return err;
  const int tiles = (n + tile_rows - 1) / tile_rows;
  int half_bits = 0;
  while ((CLASSES << (half_bits + 1)) < tile_rows) ++half_bits;
  dim3 grid((nq + evs::QM - 1) / evs::QM, tiles * BLOCKS_PER_TILE);
  tree_kernel<T><<<grid, evs::THREADS, smem, stream>>>(
      static_cast<const T*>(emb), q, nq, n, d, tile_rows, half_bits, cand_s,
      cand_i, m3);
  return (int)cudaGetLastError();
}

}  // namespace

// emb: (n, d) row-major, f32 (is_bf16 = 0) or bf16 bits (is_bf16 = 1);
// q: (nq, d) f32, already rounded to bf16 for a bf16 corpus; tile_rows: a
// power of two >= 512. Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int evs_topk_tree(const void* emb, int is_bf16, const float* q,
                             int nq, int n, int d, int tile_rows,
                             float* cand_s, int* cand_i, float* m3,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_rows < CLASSES * SEG || (tile_rows & (tile_rows - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  return is_bf16
             ? launch<uint16_t>(emb, q, nq, n, d, tile_rows, cand_s, cand_i,
                                m3, st)
             : launch<float>(emb, q, nq, n, d, tile_rows, cand_s, cand_i,
                             m3, st);
}
