// Single-query exact top-k (kernel B4 of the port).
//
// Replaces: evossearch_tpu/ops/topk_pallas.py:fused_topk (:126-171,
// pallas_call :143; body _make_kernel :79-123 and the k-step selection
// _merge_topk :52-76).
//
// Computes the exact top-k (k <= 128) of one query against an (n, d)
// corpus under (score desc, row asc): the query normalized in the kernel,
// q * rsqrt(sum(q*q) + 1e-30) with a correctly rounded rsqrt, scored with
// IEEE f32 FMAs against rows widened exactly to f32 (bf16 rows are NOT
// scored against a bf16-rounded query here, unlike kernels B1-B3). Output
// slots past the corpus, and rows scoring -FLT_MAX, read (-FLT_MAX, -1),
// as the reference's NEG_INF / -1 run buffer gives them.
//
// What bounds it on an H100: the bytes, one read of the corpus at
// 3.35 TB/s. Its 2*N*d FMAs are about 16 us of the 0.32 ms a bf16 pass of
// 1,048,576 rows of d = 512 takes. Its times beside the bound: PERF.md
// (from chip_smoke.py).
//
// Design. The reference walks its grid in order with a running top-k and
// merges a tile only when the tile's best beats the running k-th score.
// CUDA blocks run in no order, so here each block walks its own part of
// the corpus in order:
//   1. a persistent grid: one block of 256 threads per SM (at most 144,
//      chosen by the wrapper, ops/topk.py:_stream_layout), block b owning
//      the contiguous ascending tiles [b*T/B, (b+1)*T/B) of tile_rows rows
//      each (as many as fill 32 KB, at most 64);
//   2. a ring of STAGES = 6 shared-memory slots per block: thread 0 fills a
//      slot with ONE bulk (TMA) copy of a whole tile, completing on the
//      slot's mbarrier (the helpers of topk_tc.cuh), and refills it as soon
//      as the block has scored it, so five tiles (160 KB) are in flight per
//      SM while one is scored, and the loads go on through a merge;
//   3. scoring from shared memory: each lane holds its 16-byte chunks of
//      the normalized query in registers (chunk c = lane + 32j of a row),
//      a warp scores RPW = 4 rows at once with conflict-free 16-byte reads,
//      and reduces the four rows' partial sums together (one exchange
//      halving the rows per step, 6 shuffles for the four rows instead of
//      20);
//   4. the reference's skip, per row: a row whose score beats the block's
//      threshold t (its running k-th best score, -inf until k rows are in)
//      is pushed into a candidate buffer in shared memory; almost every
//      row costs one compare. When the buffer could not take another tile
//      (or, while the running list is not full, as soon as k candidates
//      wait), the block merges it into its running top-k under (score
//      desc, row asc) and raises t. Strict ">" is exact because a block
//      walks its rows in ascending order: a later row that ties t is
//      preceded by the k rows that set it. The threshold is not shared
//      across blocks;
//   5. one final merge, a second launch of one block: the blocks' k-lists
//      are merged pairwise in shared memory, ceil(log2(blocks)) rounds, one
//      warp per pair along the merge path.
//      A walk of the lists in block order with the strict threshold (the
//      reference's own order) is exact too, but it is a serial chain of
//      steps whose latency showed in the kernel's time; one block per SM
//      also halves the lists.
// A merge in a block sorts its buffer (bitonic, at most BUF entries) and
// places each running and buffered entry at its rank in the union (a
// binary search in the other list), keeping the first k: every entry has
// a distinct row, so the ranks are a permutation and no order of arrival
// matters.

#include <climits>

#include "topk_tc.cuh"

namespace {

using evs::tc::bulk_copy;
using evs::tc::mbar_expect;
using evs::tc::mbar_init;
using evs::tc::mbar_wait;
using evs::tc::smem_u32;

constexpr int THREADS = 256;         // also the query's sum of squares' order
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 6;            // ring slots
constexpr int MAX_SLOT_BYTES = 32768;  // ops/topk.py:_STREAM_SLOT_BYTES
constexpr int MAX_TILE_ROWS = 64;    // ops/topk.py:_STREAM_MAX_TILE_ROWS
constexpr int MAX_BLOCKS = 144;      // ops/topk.py:_STREAM_MAX_BLOCKS
constexpr int MAX_D = 2048;          // ops/topk.py:_STREAM_MAX_D
constexpr int MAX_K = 128;
constexpr int RPW = 4;               // rows a warp scores at once
constexpr int BUF = 256;             // ops/topk.py:_STREAM_BUF
constexpr int FINAL_THREADS = 1024;

__device__ __forceinline__ bool precedes(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// The running top-k (two copies, the merge writes the other) and the
// candidate buffer. Free running slots hold (-inf, INT_MAX).
struct Select {
  float run_s[2][MAX_K];
  int run_i[2][MAX_K];
  float buf_s[BUF];
  int buf_i[BUF];
};

// Entries of the sorted a[0, m) that precede (v, i).
__device__ __forceinline__ int preceding(const float* a_s, const int* a_i, int m,
                                         float v, int i) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (precedes(a_s[mid], a_i[mid], v, i)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Sort size (a power of two) pairs so that each precedes the next. The
// caller synchronises before; the sort ends synchronised.
__device__ void bitonic_sort(float* s, int* ix, int size, int tid) {
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < size / 2; t += THREADS) {
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

// Merge the c > 0 buffered candidates into the running top-k of copy cur
// (then cur ^= 1) and empty the buffer. Every thread of the block calls it
// with the same c, read after a barrier that follows the last push.
__device__ void merge(Select& sl, int& cur, int c, int k, int* count, int tid) {
  int p = 1;
  while (p < c) p <<= 1;
  for (int e = c + tid; e < p; e += THREADS) {
    sl.buf_s[e] = -INFINITY;
    sl.buf_i[e] = INT_MAX;
  }
  __syncthreads();  // every thread has read the count
  if (tid == 0) *count = 0;
  bitonic_sort(sl.buf_s, sl.buf_i, p, tid);
  const float* rs = sl.run_s[cur];
  const int* ri = sl.run_i[cur];
  float* ns = sl.run_s[cur ^ 1];
  int* ni = sl.run_i[cur ^ 1];
  for (int e = tid; e < k + c; e += THREADS) {
    float v;
    int i, rank;
    if (e < k) {
      v = rs[e];
      i = ri[e];
      rank = e + preceding(sl.buf_s, sl.buf_i, c, v, i);
    } else {
      v = sl.buf_s[e - k];
      i = sl.buf_i[e - k];
      rank = e - k + preceding(rs, ri, k, v, i);
    }
    if (rank < k) {
      ns[rank] = v;
      ni[rank] = i;
    }
  }
  __syncthreads();
  cur ^= 1;
}

// Merge now: the buffer could not take another step's pushes, or the
// running list is not full yet and k candidates wait.
__device__ __forceinline__ bool merge_due(int pos, float t, int k, int limit) {
  return pos >= (t == -INFINITY ? min(k - 1, limit) : limit);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(evs::FULL_MASK, v, off));
  }
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// A 16-byte chunk of a row widened exactly to f32.
__device__ __forceinline__ void widen(uint4 v, float (&r)[4], float) {
  r[0] = __uint_as_float(v.x); r[1] = __uint_as_float(v.y);
  r[2] = __uint_as_float(v.z); r[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void widen(uint4 v, float (&r)[8], uint16_t) {
  r[0] = __uint_as_float(v.x << 16); r[1] = __uint_as_float(v.x & 0xffff0000u);
  r[2] = __uint_as_float(v.y << 16); r[3] = __uint_as_float(v.y & 0xffff0000u);
  r[4] = __uint_as_float(v.z << 16); r[5] = __uint_as_float(v.z & 0xffff0000u);
  r[6] = __uint_as_float(v.w << 16); r[7] = __uint_as_float(v.w & 0xffff0000u);
}

// T: row element (float or bf16 bits); QF: query floats a lane holds
// (16, 32 or 64: d <= 512, 1024, 2048). Writes the block's top-k list,
// free slots as (-inf, INT_MAX), to list_s/list_i[blockIdx.x * k ..].
template <typename T, int QF>
__global__ void __launch_bounds__(THREADS, 1)
stream_kernel(const T* __restrict__ emb, const float* __restrict__ q_in, int n, int d,
              int k, int tile_rows, float* __restrict__ list_s,
              int* __restrict__ list_i) {
  constexpr int W = 16 / sizeof(T);  // row elements per 16-byte chunk
  constexpr int CH = QF / W;         // chunks per lane
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ Select sl;
  __shared__ float part[WARPS];
  __shared__ int count;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_bytes = d * (int)sizeof(T);
  const int slot_bytes = tile_rows * row_bytes;
  const int ntiles = (int)(((long long)n + tile_rows - 1) / tile_rows);
  // this block's tiles [t0, t0 + my), the grid's ranges ascending
  const int t0 = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  const int my = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x) - t0;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(emb);
  const uint32_t ring_u32 = smem_u32(ring);

  // tile t0 + j into slot j % STAGES (thread 0 only)
  auto issue = [&](int j) {
    const long long row0 = (long long)(t0 + j) * tile_rows;
    const int bytes = (int)min((long long)tile_rows, n - row0) * row_bytes;
    const uint32_t bar = smem_u32(&full[j % STAGES]);
    mbar_expect(bar, bytes);
    bulk_copy(ring_u32 + (j % STAGES) * slot_bytes, base + row0 * row_bytes, bytes, bar);
  };

  if (tid < STAGES) mbar_init(&full[tid]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int e = tid; e < MAX_K; e += THREADS) {  // free running slots
    sl.run_s[0][e] = -INFINITY;
    sl.run_i[0][e] = INT_MAX;
  }
  if (tid == 0) count = 0;
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < min(STAGES, my); ++j) issue(j);
  }

  // the query, normalized: sum of rounded squares, + 1e-30, rsqrt_rn
  float acc = 0.f;
  for (int c = tid; c < d; c += THREADS) {
    const float v = q_in[c];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  acc = warp_sum(acc);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total = __fadd_rn(total, part[w]);
  const float inv = __frsqrt_rn(__fadd_rn(total, 1e-30f));
  const int nch = d / W;
  float qr[CH][W];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = lane + 32 * j;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      qr[j][e] = c < nch ? __fmul_rn(__ldg(q_in + c * W + e), inv) : 0.f;
    }
  }

  const bool hi16 = lane & 16, hi8 = lane & 8;
  const int my_row = (hi16 ? 2 : 0) + (hi8 ? 1 : 0);  // of a warp's RPW rows
  const int limit = BUF - tile_rows;
  float t = -INFINITY;
  int cur = 0;
  for (int j = 0; j < my; ++j) {
    const int s = j % STAGES;
    mbar_wait(smem_u32(&full[s]), (j / STAGES) & 1);
    const uint32_t slot = ring_u32 + s * slot_bytes;
    const long long row0 = (long long)(t0 + j) * tile_rows;
    const int rows = (int)min((long long)tile_rows, n - row0);
    int pos = -1;
    for (int g = warp; g < rows; g += WARPS * RPW) {  // warp-uniform
      float a[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) a[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int c = lane + 32 * jj;
        if (c < nch) {
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const int r = g + WARPS * i;
            float x[W];
            widen(r < rows ? lds128(slot + r * row_bytes + c * 16) : make_uint4(0, 0, 0, 0),
                  x, T());
#pragma unroll
            for (int e = 0; e < W; ++e) a[i] = fmaf(x[e], qr[jj][e], a[i]);
          }
        }
      }
      // the four rows' sums together: lanes with bit 4 set keep rows 2-3,
      // then bit 3 picks one row, then the 8 lanes sharing it add up
      float b0 = hi16 ? a[2] : a[0];
      float b1 = hi16 ? a[3] : a[1];
      b0 = __fadd_rn(b0, __shfl_xor_sync(evs::FULL_MASK, hi16 ? a[0] : a[2], 16));
      b1 = __fadd_rn(b1, __shfl_xor_sync(evs::FULL_MASK, hi16 ? a[1] : a[3], 16));
      float v = hi8 ? b1 : b0;
      v = __fadd_rn(v, __shfl_xor_sync(evs::FULL_MASK, hi8 ? b0 : b1, 8));
      v = __fadd_rn(v, __shfl_xor_sync(evs::FULL_MASK, v, 4));
      v = __fadd_rn(v, __shfl_xor_sync(evs::FULL_MASK, v, 2));
      v = __fadd_rn(v, __shfl_xor_sync(evs::FULL_MASK, v, 1));
      const int r = g + WARPS * my_row;
      if ((lane & 7) == 0 && r < rows && v > t) {
        pos = atomicAdd(&count, 1);
        sl.buf_s[pos] = v;
        sl.buf_i[pos] = (int)(row0 + r);
      }
    }
    const bool due = __syncthreads_or(merge_due(pos, t, k, limit));
    // every warp is done with slot s: refill it
    if (tid == 0 && j + STAGES < my) issue(j + STAGES);
    if (due) {
      merge(sl, cur, count, k, &count, tid);
      t = sl.run_s[cur][k - 1];
    }
  }
  const int c = count;
  if (c > 0) merge(sl, cur, c, k, &count, tid);
  for (int e = tid; e < k; e += THREADS) {
    list_s[(size_t)blockIdx.x * k + e] = sl.run_s[cur][e];
    list_i[(size_t)blockIdx.x * k + e] = sl.run_i[cur][e];
  }
}

// The first k of the union of two k-lists a and b (each in (score desc,
// row asc) order) into o, by one warp along the merge path: lane l finds
// how many of the first l*per outputs come from a (a binary search on
// the path's diagonal), then merges its per outputs in order. On equal
// entries (free slots only) a goes first.
__device__ __forceinline__ void merge_pair(const float* as, const int* ai,
                                           const float* bs, const int* bi, int k,
                                           float* os, int* oi, int lane) {
  const int per = (k + 31) >> 5;
  const int d0 = lane * per;
  if (d0 >= k) return;
  int lo = max(0, d0 - k), hi = min(d0, k);
  while (lo < hi) {  // a[mid] is among the first d0 outputs?
    const int mid = (lo + hi) >> 1;
    const int j = d0 - 1 - mid;
    if (!precedes(bs[j], bi[j], as[mid], ai[mid])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = d0 - lo;
  for (int o = d0; o < min(d0 + per, k); ++o) {
    const bool take_a = j >= k || (i < k && !precedes(bs[j], bi[j], as[i], ai[i]));
    os[o] = take_a ? as[i] : bs[j];
    oi[o] = take_a ? ai[i] : bi[j];
    i += take_a;
    j += !take_a;
  }
}

// The blocks' k-lists merged pairwise in shared memory, ceil(log2(lists))
// rounds, one warp per pair; slots scoring -FLT_MAX or less read
// (-FLT_MAX, -1).
__global__ void __launch_bounds__(FINAL_THREADS)
final_kernel(const float* __restrict__ list_s, const int* __restrict__ list_i,
             int lists, int k, float* __restrict__ out_s,
             long long* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char fsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* ss = reinterpret_cast<float*>(fsm);                      // lists * k
  int* si = reinterpret_cast<int*>(ss + (size_t)lists * k);       // lists * k
  float* ds = reinterpret_cast<float*>(si + (size_t)lists * k);   // cdiv(lists, 2) * k
  int* di = reinterpret_cast<int*>(ds + (size_t)((lists + 1) / 2) * k);
#pragma unroll 4
  for (int e = tid; e < lists * k; e += FINAL_THREADS) {
    ss[e] = list_s[e];
    si[e] = list_i[e];
  }
  __syncthreads();
  for (int l = lists; l > 1; l = (l + 1) / 2) {
    // lists 2j and 2j+1 into list j; an odd last list is copied
    for (int j = warp; j < (l + 1) / 2; j += FINAL_THREADS / 32) {
      const size_t a = (size_t)2 * j * k;
      if (2 * j + 1 < l) {
        merge_pair(ss + a, si + a, ss + a + k, si + a + k, k, ds + (size_t)j * k,
                   di + (size_t)j * k, lane);
      } else {
        for (int e = lane; e < k; e += 32) {
          ds[(size_t)j * k + e] = ss[a + e];
          di[(size_t)j * k + e] = si[a + e];
        }
      }
    }
    __syncthreads();
    float* ts = ss; ss = ds; ds = ts;
    int* ti = si; si = di; di = ti;
  }
  for (int e = tid; e < k; e += FINAL_THREADS) {
    float v = lists ? ss[e] : -INFINITY;
    long long i = lists ? si[e] : -1;
    if (!(v > evs::NEG_FILL)) {
      v = evs::NEG_FILL;
      i = -1;
    }
    out_s[e] = v;
    out_i[e] = i;
  }
}

template <typename T, int QF>
int launch(const void* emb, const float* q, int n, int d, int k, int tile_rows,
           int blocks, float* list_s, int* list_i, float* out_s, long long* out_i,
           cudaStream_t stream) {
  // the opt-in above 48 KB counts the static shared memory too: always set
  if (blocks > 0) {
    const int smem = STAGES * tile_rows * d * (int)sizeof(T);
    int err = (int)cudaFuncSetAttribute(stream_kernel<T, QF>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    stream_kernel<T, QF><<<blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(emb), q, n, d, k, tile_rows, list_s, list_i);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int fsmem = (blocks + (blocks + 1) / 2) * k * 8;
  int err = (int)cudaFuncSetAttribute(final_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, fsmem);
  if (err) return err;
  final_kernel<<<1, FINAL_THREADS, fsmem, stream>>>(list_s, list_i, blocks, k, out_s, out_i);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* emb, const float* q, int n, int d, int k, int tile_rows,
             int blocks, float* list_s, int* list_i, float* out_s, long long* out_i,
             cudaStream_t stream) {
  if (d <= 512) {
    return launch<T, 16>(emb, q, n, d, k, tile_rows, blocks, list_s, list_i, out_s,
                         out_i, stream);
  }
  if (d <= 1024) {
    return launch<T, 32>(emb, q, n, d, k, tile_rows, blocks, list_s, list_i, out_s,
                         out_i, stream);
  }
  return launch<T, 64>(emb, q, n, d, k, tile_rows, blocks, list_s, list_i, out_s,
                       out_i, stream);
}

}  // namespace

// emb: (n, d) row-major, f32 (is_bf16 = 0) or bf16 bits (is_bf16 = 1),
// 16-byte aligned, d a multiple of 8 and at most 2048; q: (d,) f32,
// unnormalized; 1 <= k <= 128; tile_rows: rows of one ring slot (at most
// 64 and 32 KB); blocks: the persistent grid, 1..min(cdiv(n, tile_rows),
// 144) (0 when n = 0); list_s / list_i: blocks * k entries each. Writes (k,)
// scores and rows. Returns the CUDA error code of the first launch that
// failed (0 = all launched).
extern "C" int evs_topk_stream(const void* emb, int is_bf16, const float* q, int n,
                               int d, int k, int tile_rows, int blocks,
                               float* list_s, int* list_i, float* out_s,
                               long long* out_i, void* stream) {
  const long long row_bytes = (long long)d * (is_bf16 ? 2 : 4);
  const long long tiles = n > 0 && tile_rows > 0 ? ((long long)n + tile_rows - 1) / tile_rows : 0;
  if (k < 1 || k > MAX_K || d < 8 || d > MAX_D || d % 8 || n < 0 || tile_rows < 1 ||
      tile_rows > MAX_TILE_ROWS || tile_rows * row_bytes > MAX_SLOT_BYTES ||
      blocks < 0 || blocks > tiles || blocks > MAX_BLOCKS || (n > 0 && blocks == 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<uint16_t>(emb, q, n, d, k, tile_rows, blocks, list_s,
                                      list_i, out_s, out_i, st)
                 : launch_d<float>(emb, q, n, d, k, tile_rows, blocks, list_s,
                                   list_i, out_s, out_i, st);
}
