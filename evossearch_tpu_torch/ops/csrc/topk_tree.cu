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
// topk_tc.cuh; the figure is the score <row, q>.
//
// Both corpus dtypes run the tensor-core residue-class kernel of
// topk_tc.cuh: tc_kernel<uint16_t, RawDot> for bf16 rows (bf16 x bf16
// products are exact in f32, as in the reference's MXU pass at
// Precision.DEFAULT) and tc_kernel<float, RawDot> for f32 rows (three TF32
// passes, as the reference's Precision.HIGHEST takes three bf16 passes;
// the split and its error model are in topk_tc.cuh). Bound by its bytes on
// an H100: N*d*|Row| read once at 3.35 TB/s, against 2*Q*N*d bf16 products
// at 989 TFLOP/s or 3*2*Q*N*d TF32 products at 495 TFLOP/s.
// Times on the card beside the bounds: PERF.md (from chip_smoke.py).

#include "topk_tc.cuh"

// emb: (n, d) row-major, f32 (is_bf16 = 0) or bf16 bits (is_bf16 = 1),
// 16-byte aligned; q: (nq, d) f32, already rounded to bf16 for a bf16
// corpus, nq <= 128; tile_rows: a power of two >= 512. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int evs_topk_tree(const void* emb, int is_bf16, const float* q,
                             int nq, int n, int d, int tile_rows,
                             float* cand_s, int* cand_i, float* m3,
                             void* stream) {
  namespace tc = evs::tc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tc::Args a{emb, nullptr, q, nullptr, nq, n, d, tile_rows, cand_s, cand_i, m3};
  return is_bf16 ? tc::launch<uint16_t, tc::RawDot>(a, st)
                 : tc::launch<float, tc::RawDot>(a, st);
}
