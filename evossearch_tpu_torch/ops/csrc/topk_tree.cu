// Residue-class candidate kernel (kernel B1 of the port).
//
// Replaces: evossearch_tpu/ops/topk_pallas.py:_tree_candidates (:579 ->
// _candidates_call :606, pallas_call :635; body _make_tree_kernel :520
// and the halving tree _tree_reduce_emit :417-517), the selection pass of
// fused_topk_batch_tree (:724).
//
// For every (query, tile, residue class) the kernel emits the best two
// scores with their rows and the third-best score, ties resolved as the
// reference's halving tree resolves them, in the output layout of
// topk_class.cuh; the figure is the exact score <row, q>.
//
// Two designs, one per corpus dtype.
//
// bf16 corpus: the tensor-core residue-class kernel of topk_tc.cuh,
// tc_kernel<uint16_t, RawDot> (the figure is the exact score; bf16 x bf16
// products are exact in f32, as in the reference's MXU pass at
// Precision.DEFAULT). Bound by its bytes on an H100: N*d*2 read once.
//
// f32 corpus (tree_kernel): the tensor cores would round f32 inputs to
// TF32, so f32 stores keep IEEE f32 FMAs on the CUDA cores through
// topk_class.cuh's selection: 2*Q*N*d FMAs (67 TFLOP/s) against one read
// of the corpus per 16-query chunk.
// Times on the card beside the bounds: PERF.md (from chip_smoke.py).

#include "topk_tc.cuh"

namespace {

// ---- f32: CUDA cores -------------------------------------------------------

struct DotFigure {
  const float* __restrict__ emb;
  int d;
  const float* __restrict__ qs;

  __device__ __forceinline__ void operator()(int row,
                                             float (&acc)[evs::QM]) const {
    evs::dot_row(emb + (size_t)row * d, qs, d, acc);
  }
};

__global__ void __launch_bounds__(evs::THREADS)
tree_kernel(const float* __restrict__ emb, const float* __restrict__ q_in,
            int nq, int n, int d, int tile_rows, int half_bits,
            float* __restrict__ cand_s, int* __restrict__ cand_i,
            float* __restrict__ m3) {
  extern __shared__ float qs[];
  evs::load_queries(q_in, nq, d, blockIdx.x * evs::QM, qs);
  evs::class_select(DotFigure{emb, d, qs}, nq, n, tile_rows, half_bits,
                    cand_s, cand_i, m3);
}

int launch_f32(const float* emb, const float* q, int nq, int n, int d,
               int tile_rows, float* cand_s, int* cand_i, float* m3,
               cudaStream_t stream) {
  const int smem = evs::QM * d * (int)sizeof(float);
  const int err = evs::set_smem((const void*)tree_kernel, smem);
  if (err) return err;
  tree_kernel<<<evs::class_grid(nq, n, tile_rows), evs::THREADS, smem,
                stream>>>(emb, q, nq, n, d, tile_rows,
                          evs::class_half_bits(tile_rows), cand_s, cand_i, m3);
  return (int)cudaGetLastError();
}

}  // namespace

// emb: (n, d) row-major, f32 (is_bf16 = 0) or bf16 bits (is_bf16 = 1),
// 16-byte aligned; q: (nq, d) f32, already rounded to bf16 for a bf16
// corpus, nq <= 128; tile_rows: a power of two >= 512. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int evs_topk_tree(const void* emb, int is_bf16, const float* q,
                             int nq, int n, int d, int tile_rows,
                             float* cand_s, int* cand_i, float* m3,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_rows < evs::CLASSES * evs::CLASS_SEG || (tile_rows & (tile_rows - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  if (is_bf16) {
    const evs::tc::Args a{emb, nullptr, q, nullptr, nq, n, d, tile_rows,
                          cand_s, cand_i, m3};
    return evs::tc::launch<uint16_t, evs::tc::RawDot>(a, st);
  }
  return launch_f32(static_cast<const float*>(emb), q, nq, n, d, tile_rows,
                    cand_s, cand_i, m3, st);
}
