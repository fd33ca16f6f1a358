// SQ8 bound-sweep candidate kernel (kernel B3 of the port) and its two
// time-split variants (experiment E1).
//
// Replaces: evossearch_tpu/ops/topk_pallas.py:sq8_candidates (:664 ->
// _candidates_call :606, pallas_call :635; body _make_sq8_kernel :540-576
// and the halving tree _tree_reduce_emit :417-517), the device sweep of
// the SQ8 capacity tier (evossearch_tpu/index/sq8.py:_sq8_select).
//
// Per corpus row i the kernel computes the certified upper bound
//   u_i = <e8_i, bf16(q)> * scale_i + ||q|| * radd_i
// of the row's true score (index/sq8.py:quantize_rows derives it), then
// runs the tree's residue-class selection over the bounds: per (query,
// tile, class) the top-2 bounds with their rows and the third-best bound,
// in the reference's pre-packed layout. It is the tensor-core kernel of
// topk_tc.cuh, tc_kernel<int8_t, Bound>: int8 rows widened exactly to bf16
// in registers, the dots on the tensor cores, the bound applied in the
// selection. That header states the accumulation model the certificate
// relies on and why radd covers it.
//
// What bounds it on an H100: the bytes, N*d int8 + 8*N scalars read once
// and the outputs (Q*tiles*(256*8 + 128*4)) written once (3.35 TB/s); the
// 2*Q*N*d products on the tensor cores (989 TFLOP/s) take less at Q <= 128.
// Its times on the card beside the bound: PERF.md (from chip_smoke.py).
//
// The time-split variants (evs_topk_sq8_variant, experiment E1 of the
// port). Replace: scripts/exp_sq8_perf.py:variant_call (:65, pallas_call
// :87), bodies make_bf16_struct_kernel (:97) and make_noscale_kernel
// (:109). They exist to split B3's time: each is B3 with one piece taken
// out, on the same kernel, so the three differ only in what the variant
// removes:
//   bf16_struct  tc_kernel<uint16_t, Bound>: B3's bound over a bf16
//                corpus, no int8 widening; the scale stream and the bound
//                stay. Bound by its bytes: N*d*2 + 8*N read once.
//   int8_noscale tc_kernel<int8_t, RawDot>: the int8 corpus ranked by its
//                raw dot against the bf16-rounded queries: no scal2
//                stream, no bound. Bound by its bytes: N*d read once.
// Both also write B3's outputs.

#include "topk_tc.cuh"

// e8: (n, d) int8 row-major, d a multiple of 64, 16-byte aligned;
// scal2: (2, n) f32 [scale; radd]; q: (nq, d) f32 already rounded to bf16;
// qn: (nq,) f32 norms of the unrounded queries; tile_rows: a power of two
// >= 512. Returns the CUDA error code of the launch (0 = launched).
extern "C" int evs_topk_sq8(const void* e8, const float* scal2,
                            const float* q, const float* qn, int nq, int n,
                            int d, int tile_rows, float* cand_s, int* cand_i,
                            float* m3, void* stream) {
  const evs::tc::Args a{e8, scal2, q, qn, nq, n, d, tile_rows, cand_s, cand_i, m3};
  return evs::tc::launch<int8_t, evs::tc::Bound>(a, static_cast<cudaStream_t>(stream));
}

// The time-split variants of B3 (see the note at the top). variant 0 =
// bf16_struct: corpus (n, d) bf16 bits, scal2 (2, n) f32 [scale; radd], qn
// (nq,) f32 norms; variant 1 = int8_noscale: corpus (n, d) int8, scal2
// and qn unused (may be null). q: (nq, d) f32 already rounded to bf16;
// tile_rows: a power of two >= 512. Returns the CUDA error code of the
// launch (0 = launched).
extern "C" int evs_topk_sq8_variant(int variant, const void* corpus,
                                    const float* scal2, const float* q,
                                    const float* qn, int nq, int n, int d,
                                    int tile_rows, float* cand_s, int* cand_i,
                                    float* m3, void* stream) {
  const evs::tc::Args a{corpus, scal2, q, qn, nq, n, d, tile_rows, cand_s, cand_i, m3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return evs::tc::launch<uint16_t, evs::tc::Bound>(a, st);
    case 1: return evs::tc::launch<int8_t, evs::tc::RawDot>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
