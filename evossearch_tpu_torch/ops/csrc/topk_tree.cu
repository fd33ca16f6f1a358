// Residue-class candidate kernel (kernel B1 of the port).
//
// Replaces: evossearch_tpu/ops/topk_pallas.py:_tree_candidates (:579 ->
// _candidates_call :606, pallas_call :635; body _make_tree_kernel :520
// and the halving tree _tree_reduce_emit :417-517), the selection pass of
// fused_topk_batch_tree (:724).
//
// For every (query, tile, residue class) the kernel emits the best two
// scores with their rows and the third-best score, ties resolved as the
// reference's halving tree resolves them: the selection and its output
// layout are topk_class.cuh's, the figure is the exact score <row, q>.
//
// What bounds it on an H100: as the block kernel, 2*Q*N*d f32 FMAs on the
// CUDA cores against one read of the corpus.
// Its times on the card beside the bound: PERF.md (from chip_smoke.py).
// What this simple design leaves on the table: no tensor cores, no staging
// of rows through shared memory, the corpus is read once per 16-query
// chunk, and a tile's 128 classes are spread over 4 blocks that each read
// a quarter of every 128-row group.

#include "topk_class.cuh"

namespace {

template <typename T>
struct DotFigure {
  const T* __restrict__ emb;
  int d;
  const float* __restrict__ qs;

  __device__ __forceinline__ void operator()(int row,
                                             float (&acc)[evs::QM]) const {
    evs::dot_row<T>(emb + (size_t)row * d, qs, d, acc);
  }
};

template <typename T>
__global__ void __launch_bounds__(evs::THREADS)
tree_kernel(const T* __restrict__ emb, const float* __restrict__ q_in, int nq,
            int n, int d, int tile_rows, int half_bits,
            float* __restrict__ cand_s, int* __restrict__ cand_i,
            float* __restrict__ m3) {
  extern __shared__ float qs[];
  evs::load_queries(q_in, nq, d, blockIdx.x * evs::QM, qs);
  evs::class_select(DotFigure<T>{emb, d, qs}, nq, n, tile_rows, half_bits,
                    cand_s, cand_i, m3);
}

template <typename T>
int launch(const void* emb, const float* q, int nq, int n, int d,
           int tile_rows, float* cand_s, int* cand_i, float* m3,
           cudaStream_t stream) {
  const int smem = evs::QM * d * (int)sizeof(float);
  const int err = evs::set_smem((const void*)tree_kernel<T>, smem);
  if (err) return err;
  tree_kernel<T><<<evs::class_grid(nq, n, tile_rows), evs::THREADS, smem,
                   stream>>>(static_cast<const T*>(emb), q, nq, n, d,
                             tile_rows, evs::class_half_bits(tile_rows),
                             cand_s, cand_i, m3);
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
  if (tile_rows < evs::CLASSES * evs::CLASS_SEG || (tile_rows & (tile_rows - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  return is_bf16
             ? launch<uint16_t>(emb, q, nq, n, d, tile_rows, cand_s, cand_i,
                                m3, st)
             : launch<float>(emb, q, nq, n, d, tile_rows, cand_s, cand_i,
                             m3, st);
}
