// Per-block candidate kernel (kernel B2 of the port).
//
// Replaces: evossearch_tpu/ops/topk_pallas.py:_block_candidates (:279,
// pallas_call :297; body _make_batch_kernel :201-276), the selection pass
// of fused_topk_batch (:317).
//
// Computes, for each query q < nq and each 256-row block b < L of the
// corpus, the top-LEV scores of the block under (score desc, row asc) and
// the rows of the first LEV-1 of them. Rows at or past n score -FLT_MAX
// (the reference's NEG_INF), and a level scoring -FLT_MAX names the
// block's first row, so the output covers the reference's padded grid of
// L = cdiv(n, 2048) * 8 blocks cell for cell:
//   out_s: (LEV, L, nq) f32    out_i: (LEV-1, L, nq) i32
//
// Design: one warp per (256-row block, chunk of QM=16 queries); each lane
// walks 8 consecutive rows in ascending order, scoring each row against
// its 16 queries (f32 FMA, bf16 rows widened exactly) and keeping a running
// top-LEV per query; the 32 lane states then merge left to right (earlier
// rows win ties), which is exactly the block's top-LEV.
//
// What bounds it on an H100: the scores are 2*Q*N*d f32 FMAs on the CUDA
// cores (67 TFLOP/s peak) against N*d*itemsize corpus bytes (3.35 TB/s);
// at Q = 48, d = 512 that is operations for f32 and, were the product on
// the tensor cores, bytes for bf16.
// Its times on the card beside the bound: PERF.md (from chip_smoke.py).
// What this simple design leaves on the table: no tensor cores (wgmma), no
// TMA or cp.async staging of rows through shared memory (each lane reads
// its own row with 16-byte loads, half of each 32-byte sector per load),
// queries beyond a multiple of 16 are computed and dropped, and the corpus
// is read once per 16-query chunk (adjacent blocks share it through L2).

#include "topk_common.cuh"

namespace {

constexpr int SUB_ROWS = 256;
constexpr int SEG = 32;                              // lanes per block
constexpr int ROWS_PER_LANE = SUB_ROWS / SEG;        // 8
constexpr int SLOTS_PER_BLOCK = evs::THREADS / SEG;  // 4 row blocks

template <typename T, int LEV>
__global__ void __launch_bounds__(evs::THREADS)
block_kernel(const T* __restrict__ emb, const float* __restrict__ q_in,
             int nq, int n, int d, int L, float* __restrict__ out_s,
             int* __restrict__ out_i) {
  extern __shared__ float qs[];
  const int q0 = blockIdx.x * evs::QM;
  evs::load_queries(q_in, nq, d, q0, qs);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y * SLOTS_PER_BLOCK + warp;  // warp-uniform

  float s[evs::QM][LEV];
  int ix[evs::QM][LEV];
  evs::init_state<LEV>(s, ix);
  if (b < L) {
    const int r0 = b * SUB_ROWS + lane * ROWS_PER_LANE;
    for (int t = 0; t < ROWS_PER_LANE; ++t) {
      evs::visit_row<T, LEV>(emb, n, d, qs, r0 + t, s, ix);
    }
  }
  evs::merge_segments<LEV, SEG>(s, ix);

  if (lane == 0 && b < L) {
#pragma unroll
    for (int q = 0; q < evs::QM; ++q) {
      if (q0 + q < nq) {
#pragma unroll
        for (int lvl = 0; lvl < LEV; ++lvl) {
          out_s[((size_t)lvl * L + b) * nq + q0 + q] = s[q][lvl];
        }
#pragma unroll
        for (int lvl = 0; lvl < LEV - 1; ++lvl) {
          // a level past the block's real rows names the block's first
          // row, as the reference's NEG_INF knock-out does
          out_i[((size_t)lvl * L + b) * nq + q0 + q] =
              s[q][lvl] == evs::NEG_FILL ? b * SUB_ROWS : ix[q][lvl];
        }
      }
    }
  }
}

template <typename T, int LEV>
int launch(const void* emb, const float* q, int nq, int n, int d, int L,
           float* out_s, int* out_i, cudaStream_t stream) {
  const int smem = evs::QM * d * (int)sizeof(float);
  const int err = evs::set_smem((const void*)block_kernel<T, LEV>, smem);
  if (err) return err;
  dim3 grid((nq + evs::QM - 1) / evs::QM,
            (L + SLOTS_PER_BLOCK - 1) / SLOTS_PER_BLOCK);
  block_kernel<T, LEV><<<grid, evs::THREADS, smem, stream>>>(
      static_cast<const T*>(emb), q, nq, n, d, L, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// emb: (n, d) row-major, f32 (is_bf16 = 0) or bf16 bits (is_bf16 = 1);
// q: (nq, d) f32, already rounded to bf16 for a bf16 corpus. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int evs_topk_block(const void* emb, int is_bf16, const float* q,
                              int nq, int n, int d, int levels, int L,
                              float* out_s, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (levels == 3) {
    return is_bf16 ? launch<uint16_t, 3>(emb, q, nq, n, d, L, out_s, out_i, st)
                   : launch<float, 3>(emb, q, nq, n, d, L, out_s, out_i, st);
  }
  if (levels == 4) {
    return is_bf16 ? launch<uint16_t, 4>(emb, q, nq, n, d, L, out_s, out_i, st)
                   : launch<float, 4>(emb, q, nq, n, d, L, out_s, out_i, st);
  }
  return (int)cudaErrorInvalidValue;
}
