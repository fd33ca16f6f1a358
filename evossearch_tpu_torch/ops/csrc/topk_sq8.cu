// SQ8 bound-sweep candidate kernel (kernel B3 of the port).
//
// Replaces: evossearch_tpu/ops/topk_pallas.py:sq8_candidates (:664 ->
// _candidates_call :606, pallas_call :635; body _make_sq8_kernel :540-576
// and the halving tree _tree_reduce_emit :417-517), the device sweep of
// the SQ8 capacity tier (evossearch_tpu/index/sq8.py:_sq8_select).
//
// Per corpus row i the kernel computes the certified upper bound
//   u_i = <e8_i, bf16(q)> * scale_i + ||q|| * radd_i
// of the row's true score (index/sq8.py:quantize_rows derives it), then
// runs the tree kernel's residue-class selection (topk_class.cuh) over the
// bounds: per (query, tile, class) the top-2 bounds with their rows and
// the third-best bound, in the reference's pre-packed layout.
//
// Numerics: the queries arrive already rounded to bf16 (whatever the store
// dtype). int8 widens exactly to f32 and every product int8 x bf16 fits a
// float exactly, so only the f32 accumulation rounds, and the
// accumulation term of radd (2*d*2^-24*||scale*e8||*||q||) bounds that
// for any order of the d additions, this kernel's FMA order included.
// The bound's two products and its sum are written with __fmul_rn /
// __fadd_rn so the compiler cannot contract them into an FMA: the plain
// version rounds each of the three, and on exact-dot inputs the two agree
// bit for bit.
//
// What bounds it on an H100: the bytes, N*d int8 + 8*N scalars read once
// (3.35 TB/s); the 2*Q*N*d products, exact as bf16 x bf16 on the tensor
// cores (989 TFLOP/s), take less at Q <= 128. This kernel runs them as f32
// FMAs on the CUDA cores (67 TFLOP/s), which at Q = 48, d = 512 take
// longer than the bytes.
// Its times on the card beside the bound: PERF.md (from chip_smoke.py).
// What this simple design leaves on the table: as the tree kernel (no
// tensor cores, which would take int8 x int8 only after quantizing the
// query, no staging through shared memory, one corpus read per 16-query
// chunk), with 16-byte int8 loads in place of the tree kernel's 16-byte
// bf16 loads.

#include "topk_class.cuh"

namespace {

struct BoundFigure {
  const int8_t* __restrict__ e8;
  const float* __restrict__ scale;
  const float* __restrict__ radd;
  int d;
  const float* __restrict__ qs;   // (d, QM) bf16-rounded queries
  const float* __restrict__ qn;   // (QM,) ||q|| of the f32 queries

  __device__ __forceinline__ void operator()(int row,
                                             float (&acc)[evs::QM]) const {
    evs::dot_row<int8_t>(e8 + (size_t)row * d, qs, d, acc);
    const float sc = __ldg(scale + row);
    const float ra = __ldg(radd + row);
#pragma unroll
    for (int q = 0; q < evs::QM; ++q) {
      acc[q] = __fadd_rn(__fmul_rn(acc[q], sc), __fmul_rn(qn[q], ra));
    }
  }
};

__global__ void __launch_bounds__(evs::THREADS)
sq8_kernel(const int8_t* __restrict__ e8, const float* __restrict__ scal2,
           const float* __restrict__ q_in, const float* __restrict__ qn_in,
           int nq, int n, int d, int tile_rows, int half_bits,
           float* __restrict__ cand_s, int* __restrict__ cand_i,
           float* __restrict__ m3) {
  extern __shared__ float qs[];          // QM*d queries, then QM norms
  float* qn = qs + evs::QM * d;
  const int q0 = blockIdx.x * evs::QM;
  if (threadIdx.x < evs::QM) {
    qn[threadIdx.x] = q0 + threadIdx.x < nq ? qn_in[q0 + threadIdx.x] : 0.f;
  }
  evs::load_queries(q_in, nq, d, q0, qs);  // ends with __syncthreads
  evs::class_select(BoundFigure{e8, scal2, scal2 + n, d, qs, qn}, nq, n,
                    tile_rows, half_bits, cand_s, cand_i, m3);
}

}  // namespace

// e8: (n, d) int8 row-major, d a multiple of 16, 16-byte aligned;
// scal2: (2, n) f32 [scale; radd]; q: (nq, d) f32 already rounded to bf16;
// qn: (nq,) f32 norms of the unrounded queries; tile_rows: a power of two
// >= 512. Returns the CUDA error code of the launch (0 = launched).
extern "C" int evs_topk_sq8(const void* e8, const float* scal2,
                            const float* q, const float* qn, int nq, int n,
                            int d, int tile_rows, float* cand_s, int* cand_i,
                            float* m3, void* stream) {
  if (tile_rows < evs::CLASSES * evs::CLASS_SEG ||
      (tile_rows & (tile_rows - 1)) || d % evs::RowVec<int8_t>::W) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = evs::QM * (d + 1) * (int)sizeof(float);
  const int err = evs::set_smem((const void*)sq8_kernel, smem);
  if (err) return err;
  sq8_kernel<<<evs::class_grid(nq, n, tile_rows), evs::THREADS, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(e8), scal2, q, qn, nq, n, d, tile_rows,
      evs::class_half_bits(tile_rows), cand_s, cand_i, m3);
  return (int)cudaGetLastError();
}
