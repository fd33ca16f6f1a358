// Single-query exact top-k (kernel B4 of the port).
//
// Replaces: evossearch_tpu/ops/topk_pallas.py:fused_topk (:126-171,
// pallas_call :143; body _make_kernel :79-123 and the k-step selection
// _merge_topk :52-76).
//
// Computes the exact top-k (k <= 128) of one query against an (n, d)
// corpus under (score desc, row asc): the query normalized in the kernel,
// q * rsqrt(sum(q*q) + 1e-30) with a correctly rounded rsqrt, scored in
// f32 against rows widened exactly to f32 (bf16 rows are NOT scored
// against a bf16-rounded query here, unlike kernels B1-B3). Output slots
// past the corpus, and rows scoring -FLT_MAX, read (-FLT_MAX, -1), as the
// reference's NEG_INF / -1 run buffer gives them.
//
// Design: the reference walks the grid in order with a running top-k and
// skips tiles that cannot beat it; CUDA blocks have no order, so:
//   1. score pass: block b scores rows [b*block_rows, (b+1)*block_rows)
//      (one warp per row at a time, 16-byte loads across the lanes, a
//      shuffle-tree sum), bitonic-sorts (score, row) pairs in shared
//      memory under (score desc, row asc) and writes its top k;
//   2. merge passes: each block sorts MERGE_ROWS of those candidates the
//      same way and keeps k, until one block's k remain.
// The result is the exact top-k of the whole corpus under the tie rule
// whatever the blocks' order, so it equals the reference's.
//
// What bounds it on an H100: the bytes, one read of the corpus (3.35 TB/s);
// 2*N*d operations are far below any compute peak.
// Its times on the card beside the bound: PERF.md (from chip_smoke.py).
// What this simple design leaves on the table: a full bitonic sort of
// every block (the reference's tile skip would avoid most of it), the
// merge passes' extra launches, and no overlap of loads with the sort.

#include <climits>

#include "topk_common.cuh"

namespace {

constexpr int STREAM_THREADS = 256;
constexpr int WARPS = STREAM_THREADS / 32;
constexpr int MERGE_ROWS = 2048;

__device__ __forceinline__ bool precedes(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Sort size (a power of two) pairs in shared memory so that each precedes
// the next. The caller synchronises before; the sort ends synchronised.
__device__ void bitonic_sort(float* s, int* ix, int size) {
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < size / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (j - 1));
        const int hi = lo + j;
        const bool up = (lo & k) == 0;
        const float sl = s[lo], sh = s[hi];
        const int il = ix[lo], ih = ix[hi];
        if (precedes(sh, ih, sl, il) == up) {
          s[lo] = sh; s[hi] = sl;
          ix[lo] = ih; ix[hi] = il;
        }
      }
      __syncthreads();
    }
  }
}

// Row elements per 16-byte load.
template <typename T> struct Vec16 { static constexpr int W = 16 / sizeof(T); };

__device__ __forceinline__ void widen(const float* p, float (&r)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

__device__ __forceinline__ void widen(const uint16_t* p, float (&r)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  r[0] = __uint_as_float(v.x << 16); r[1] = __uint_as_float(v.x & 0xffff0000u);
  r[2] = __uint_as_float(v.y << 16); r[3] = __uint_as_float(v.y & 0xffff0000u);
  r[4] = __uint_as_float(v.z << 16); r[5] = __uint_as_float(v.z & 0xffff0000u);
  r[6] = __uint_as_float(v.w << 16); r[7] = __uint_as_float(v.w & 0xffff0000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(evs::FULL_MASK, v, off));
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(STREAM_THREADS)
score_kernel(const T* __restrict__ emb, const float* __restrict__ q_in,
             int n, int d, int block_rows, int k, float* __restrict__ out_s,
             int* __restrict__ out_i) {
  constexpr int W = Vec16<T>::W;
  extern __shared__ float smem[];
  float* qs = smem;                                   // d
  float* s = qs + d;                                  // block_rows
  int* ix = reinterpret_cast<int*>(s + block_rows);   // block_rows
  __shared__ float part[WARPS];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the query, normalized: sum of rounded squares, + 1e-30, rsqrt_rn
  float acc = 0.f;
  for (int c = threadIdx.x; c < d; c += STREAM_THREADS) {
    const float v = q_in[c];
    qs[c] = v;
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  acc = warp_sum(acc);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total = __fadd_rn(total, part[w]);
  const float inv = __frsqrt_rn(__fadd_rn(total, 1e-30f));
  for (int c = threadIdx.x; c < d; c += STREAM_THREADS) {
    qs[c] = __fmul_rn(qs[c], inv);
  }
  __syncthreads();

  const int base = blockIdx.x * block_rows;
  for (int r = warp; r < block_rows; r += WARPS) {
    const int row = base + r;
    float v = evs::NEG_FILL;
    if (row < n) {  // warp-uniform
      const T* p = emb + (size_t)row * d;
      float a = 0.f;
      for (int c = lane * W; c < d; c += 32 * W) {
        float x[W];
        widen(p + c, x);
#pragma unroll
        for (int e = 0; e < W; ++e) a = fmaf(x[e], qs[c + e], a);
      }
      v = warp_sum(a);
    }
    if (lane == 0) {
      s[r] = v;
      ix[r] = row;
    }
  }
  __syncthreads();
  bitonic_sort(s, ix, block_rows);
  for (int t = threadIdx.x; t < k; t += STREAM_THREADS) {
    out_s[(size_t)blockIdx.x * k + t] = s[t];
    out_i[(size_t)blockIdx.x * k + t] = ix[t];
  }
}

// Top k of each MERGE_ROWS-long run of m candidates. The last pass (one
// block) maps slots scoring -FLT_MAX or less to (-FLT_MAX, -1).
__global__ void __launch_bounds__(STREAM_THREADS)
merge_kernel(const float* __restrict__ in_s, const int* __restrict__ in_i,
             int m, int k, int last, float* __restrict__ out_s,
             int* __restrict__ out_i) {
  __shared__ float s[MERGE_ROWS];
  __shared__ int ix[MERGE_ROWS];
  const size_t base = (size_t)blockIdx.x * MERGE_ROWS;
  for (int t = threadIdx.x; t < MERGE_ROWS; t += STREAM_THREADS) {
    const bool real = base + t < (size_t)m;
    s[t] = real ? in_s[base + t] : -INFINITY;
    ix[t] = real ? in_i[base + t] : INT_MAX;
  }
  __syncthreads();
  bitonic_sort(s, ix, MERGE_ROWS);
  for (int t = threadIdx.x; t < k; t += STREAM_THREADS) {
    float v = s[t];
    int i = ix[t];
    if (last && !(v > evs::NEG_FILL)) {
      v = evs::NEG_FILL;
      i = -1;
    }
    out_s[(size_t)blockIdx.x * k + t] = v;
    out_i[(size_t)blockIdx.x * k + t] = i;
  }
}

template <typename T>
int launch(const void* emb, const float* q, int n, int d, int k,
           int block_rows, float* scratch_s, int* scratch_i, float* out_s,
           int* out_i, cudaStream_t stream) {
  const int smem = d * (int)sizeof(float) + block_rows * 8;
  int err = evs::set_smem((const void*)score_kernel<T>, smem);
  if (err) return err;
  const int blocks = (n + block_rows - 1) / block_rows;
  score_kernel<T><<<blocks, STREAM_THREADS, smem, stream>>>(
      static_cast<const T*>(emb), q, n, d, block_rows, k, scratch_s,
      scratch_i);
  err = (int)cudaGetLastError();
  if (err) return err;
  // ping-pong between the two halves of the scratch
  const size_t half = (size_t)blocks * k;
  float* src_s = scratch_s;
  int* src_i = scratch_i;
  int m = blocks * k;
  for (;;) {
    const int chunks = (m + MERGE_ROWS - 1) / MERGE_ROWS;
    const bool last = chunks == 1;
    float* dst_s = last ? out_s : (src_s == scratch_s ? scratch_s + half : scratch_s);
    int* dst_i = last ? out_i : (src_i == scratch_i ? scratch_i + half : scratch_i);
    merge_kernel<<<chunks, STREAM_THREADS, 0, stream>>>(src_s, src_i, m, k,
                                                       last, dst_s, dst_i);
    err = (int)cudaGetLastError();
    if (err || last) return err;
    src_s = dst_s;
    src_i = dst_i;
    m = chunks * k;
  }
}

}  // namespace

// emb: (n, d) row-major, f32 (is_bf16 = 0) or bf16 bits (is_bf16 = 1),
// 16-byte aligned, d a multiple of 8; q: (d,) f32, unnormalized;
// 1 <= k <= 128; block_rows: a power of two in [128, 4096]; scratch_s /
// scratch_i: 2 * cdiv(n, block_rows) * k entries each. Writes (k,)
// scores and rows. Returns the CUDA error code of the first launch that
// failed (0 = all launched).
extern "C" int evs_topk_stream(const void* emb, int is_bf16, const float* q,
                               int n, int d, int k, int block_rows,
                               float* scratch_s, int* scratch_i,
                               float* out_s, int* out_i, void* stream) {
  if (k < 1 || k > 128 || block_rows < 128 || block_rows > 4096 ||
      (block_rows & (block_rows - 1)) || d % 8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<uint16_t>(emb, q, n, d, k, block_rows, scratch_s,
                                    scratch_i, out_s, out_i, st)
                 : launch<float>(emb, q, n, d, k, block_rows, scratch_s,
                                 scratch_i, out_s, out_i, st);
}
