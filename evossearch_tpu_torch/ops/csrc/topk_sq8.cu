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
// What this simple design leaves on the table: as the tree kernel's f32
// path (no tensor cores, which would take int8 x int8 only after
// quantizing the query, no staging through shared memory, one corpus read
// per 16-query chunk), with 16-byte int8 loads.
//
// The time-split variants (evs_topk_sq8_variant, experiment E1 of the
// port). Replace: scripts/exp_sq8_perf.py:variant_call (:65, pallas_call
// :87), bodies make_bf16_struct_kernel (:97) and make_noscale_kernel
// (:109). They exist to split B3's time: each is B3 with one piece taken
// out, on the same residue-class selection (class_select) and the same
// thread layout, so the three differ only in what the variant removes:
//   bf16_struct  B3's bound over a bf16 corpus: the int8 widening is
//                gone (the bf16 widening is a shift), the scale stream and
//                the bound stay. Bound by its bytes: N*d*2 + 8*N read once.
//   int8_noscale the int8 corpus ranked by its raw dot against the
//                bf16-rounded queries: no scal2 stream, no bound. Bound by
//                its bytes: N*d read once.
// Both also write B3's outputs (Q*tiles*(256*8 + 128*4) bytes).

#include "topk_class.cuh"

namespace {

// B3's bound over an int8 corpus, and over a bf16 one (bf16_struct)
template <typename T>
struct BoundFigure {
  const T* __restrict__ e;
  const float* __restrict__ scale;
  const float* __restrict__ radd;
  int d;
  const float* __restrict__ qs;   // (d, QM) bf16-rounded queries
  const float* __restrict__ qn;   // (QM,) ||q|| of the f32 queries

  __device__ __forceinline__ void operator()(int row,
                                             float (&acc)[evs::QM]) const {
    evs::dot_row<T>(e + (size_t)row * d, qs, d, acc);
    const float sc = __ldg(scale + row);
    const float ra = __ldg(radd + row);
#pragma unroll
    for (int q = 0; q < evs::QM; ++q) {
      acc[q] = __fadd_rn(__fmul_rn(acc[q], sc), __fmul_rn(qn[q], ra));
    }
  }
};

// int8_noscale: the raw dot of the int8 corpus
struct RawDotFigure {
  const int8_t* __restrict__ e8;
  int d;
  const float* __restrict__ qs;

  __device__ __forceinline__ void operator()(int row,
                                             float (&acc)[evs::QM]) const {
    evs::dot_row<int8_t>(e8 + (size_t)row * d, qs, d, acc);
  }
};

// Shared memory of B3 and its variants: QM*d queries, then QM norms.
__device__ __forceinline__ float* load_sq8_queries(const float* __restrict__ q_in,
                                                   const float* __restrict__ qn_in,
                                                   int nq, int d, float* qs) {
  float* qn = qs + evs::QM * d;
  const int q0 = blockIdx.x * evs::QM;
  if (threadIdx.x < evs::QM) {
    qn[threadIdx.x] =
        qn_in != nullptr && q0 + threadIdx.x < nq ? qn_in[q0 + threadIdx.x] : 0.f;
  }
  evs::load_queries(q_in, nq, d, q0, qs);  // ends with __syncthreads
  return qn;
}

__global__ void __launch_bounds__(evs::THREADS)
sq8_kernel(const int8_t* __restrict__ e8, const float* __restrict__ scal2,
           const float* __restrict__ q_in, const float* __restrict__ qn_in,
           int nq, int n, int d, int tile_rows, int half_bits,
           float* __restrict__ cand_s, int* __restrict__ cand_i,
           float* __restrict__ m3) {
  extern __shared__ float qs[];
  const float* qn = load_sq8_queries(q_in, qn_in, nq, d, qs);
  evs::class_select(BoundFigure<int8_t>{e8, scal2, scal2 + n, d, qs, qn}, nq, n,
                    tile_rows, half_bits, cand_s, cand_i, m3);
}

__global__ void __launch_bounds__(evs::THREADS)
bf16_struct_kernel(const uint16_t* __restrict__ emb,
                   const float* __restrict__ scal2,
                   const float* __restrict__ q_in,
                   const float* __restrict__ qn_in, int nq, int n, int d,
                   int tile_rows, int half_bits, float* __restrict__ cand_s,
                   int* __restrict__ cand_i, float* __restrict__ m3) {
  extern __shared__ float qs[];
  const float* qn = load_sq8_queries(q_in, qn_in, nq, d, qs);
  evs::class_select(BoundFigure<uint16_t>{emb, scal2, scal2 + n, d, qs, qn}, nq,
                    n, tile_rows, half_bits, cand_s, cand_i, m3);
}

__global__ void __launch_bounds__(evs::THREADS)
int8_noscale_kernel(const int8_t* __restrict__ e8,
                    const float* __restrict__ q_in, int nq, int n, int d,
                    int tile_rows, int half_bits, float* __restrict__ cand_s,
                    int* __restrict__ cand_i, float* __restrict__ m3) {
  extern __shared__ float qs[];
  load_sq8_queries(q_in, nullptr, nq, d, qs);
  evs::class_select(RawDotFigure{e8, d, qs}, nq, n, tile_rows, half_bits,
                    cand_s, cand_i, m3);
}

bool bad_shape(int tile_rows, int d) {
  return tile_rows < evs::CLASSES * evs::CLASS_SEG ||
         (tile_rows & (tile_rows - 1)) || d % evs::RowVec<int8_t>::W;
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
  if (bad_shape(tile_rows, d)) return (int)cudaErrorInvalidValue;
  const int smem = evs::QM * (d + 1) * (int)sizeof(float);
  const int err = evs::set_smem((const void*)sq8_kernel, smem);
  if (err) return err;
  sq8_kernel<<<evs::class_grid(nq, n, tile_rows), evs::THREADS, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(e8), scal2, q, qn, nq, n, d, tile_rows,
      evs::class_half_bits(tile_rows), cand_s, cand_i, m3);
  return (int)cudaGetLastError();
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
  if (bad_shape(tile_rows, d) || variant < 0 || variant > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = evs::QM * (d + 1) * (int)sizeof(float);
  const void* kernel = variant == 0 ? (const void*)bf16_struct_kernel
                                    : (const void*)int8_noscale_kernel;
  const int err = evs::set_smem(kernel, smem);
  if (err) return err;
  const dim3 grid = evs::class_grid(nq, n, tile_rows);
  const int half_bits = evs::class_half_bits(tile_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    bf16_struct_kernel<<<grid, evs::THREADS, smem, st>>>(
        static_cast<const uint16_t*>(corpus), scal2, q, qn, nq, n, d,
        tile_rows, half_bits, cand_s, cand_i, m3);
  } else {
    int8_noscale_kernel<<<grid, evs::THREADS, smem, st>>>(
        static_cast<const int8_t*>(corpus), q, nq, n, d, tile_rows,
        half_bits, cand_s, cand_i, m3);
  }
  return (int)cudaGetLastError();
}
