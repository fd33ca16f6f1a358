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
// Both corpus dtypes run block_tc_kernel, on the copy, query and MMA
// phases of the tensor-core kernel in topk_tc.cuh, on a walk of its own:
// bf16 x bf16 products (exact in f32) for bf16 rows, three TF32 passes for
// f32 rows (the split and its error model are in topk_tc.cuh). One CUDA
// block per 2048-row tile (8 of B2's blocks) serves every query of the
// launch (the corpus is read once; only where the queries and two ring
// slots do not fit, at a wide d or above 64 f32 queries, are the queries
// cut into chunks). Rank r of the walk is rows r*R .. r*R+R-1 (R = C/8;
// C = 32 for bf16, 16 for f32, whose 32-row slots would not fit twice
// beside 48 f32 queries at d = 512) of each of the tile's 8 blocks, block
// w as ring group w: one bulk copy per group, so slab column w*R + i is
// block w's row r*R + i. The 256/R ranks go in ascending order, and thread
// (warp w, lane) inserts block w's R dots of each of its queries (lane +
// 32*j) into a running top-LEV with strict ">", so each block's rows
// arrive in ascending order and an equal score that came earlier stays
// ahead: the reference's lowest index among equal scores, with no merge.
// Exact-dot inputs give the plain version's scores bit for bit on both
// dtypes. Bound by its bytes on an H100: N*d*|Row| read once at 3.35
// TB/s, against 2*Q*N*d bf16 products at 989 TFLOP/s or 3*2*Q*N*d TF32
// products at 495 TFLOP/s.
// Times on the card beside the bounds: PERF.md (from chip_smoke.py).

#include "topk_tc.cuh"

namespace {

constexpr int SUB_ROWS = 256;

namespace tc = evs::tc;

constexpr int TILE_ROWS = 2048;                      // rows per CUDA block
constexpr int BLOCKS_PER_TILE = TILE_ROWS / SUB_ROWS;
static_assert(BLOCKS_PER_TILE == tc::WARPS, "one selection warp per 256-row block");

// Rows per rank: 32 for bf16 rows, 16 for f32 (R = C/8 of each block).
template <typename Row>
__host__ __device__ constexpr int rank_rows() {
  return sizeof(Row) == 4 ? 16 : 32;
}

// Block (tile, query chunk). Copies and MMA as tc_kernel (topk_tc.cuh);
// selection: thread (warp w, lane) keeps the top-LEV of B2 block w of the
// tile for the queries lane + 32*j in registers.
template <typename Row, int C, int LEV, int QCAP>
__global__ void __launch_bounds__(tc::Shape<C, QCAP>::BLOCK, 1)
block_tc_kernel(const Row* __restrict__ emb_in, const float* __restrict__ q_in,
                int nq, int n, int d, int L, float* __restrict__ out_s,
                int* __restrict__ out_i, int qc, int slots) {
  using Sh = tc::Shape<C, QCAP>;
  constexpr int QPT = (QCAP + 31) / 32, LD = Sh::LD, EB = sizeof(Row);
  constexpr int R = C / 8;                           // rows of each block
  constexpr int RANKS = SUB_ROWS / R;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[tc::MAX_SLOTS];
  const unsigned char* __restrict__ emb = reinterpret_cast<const unsigned char*>(emb_in);
  const int gp = tc::group_pitch<Row>(C, d);
  const int slot_bytes = 8 * gp;
  uint16_t* qsm = reinterpret_cast<uint16_t*>(smem);
  unsigned char* ring = smem + (size_t)qc * d * tc::query_bytes<Row>();
  float* slab = reinterpret_cast<float*>(ring + (size_t)slots * slot_bytes);

  // the thread index, read once and kept in a register (see tc_kernel)
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  const int warp = tid >> 5, lane = tid & 31;
  const long long tile_base = (long long)blockIdx.x * TILE_ROWS;
  const int q0 = blockIdx.y * qc;
  const int nql = min(qc, nq - q0);              // this block's queries
  const int nt = (nql + 7) >> 3;                 // their 8-query tiles

  // rank r: rows r*R.. of each block, block w's as ring group w; copier
  // thread 0 counts the live rows of all 8 groups (fewer in the last tile)
  const bool copier = Sh::COPY_WARP ? warp == tc::WARPS : true;
  const int cw = Sh::COPY_WARP ? lane : (lane == 0 ? warp : 8);
  const bool copy_only = Sh::COPY_WARP && warp == tc::WARPS;
  auto issue = [&](int r) {
    const long long row0 = tile_base + r * R;
    int rows = 0;
    if (cw == 0) {
#pragma unroll
      for (int w = 0; w < BLOCKS_PER_TILE; ++w) {
        rows += (int)max(0LL, min((long long)R, (long long)n - (row0 + w * SUB_ROWS)));
      }
    }
    tc::issue_rank<EB, R, SUB_ROWS>(emb, row0, rows, n, d, cw,
                                    tc::smem_u32(ring + (size_t)(r % slots) * slot_bytes),
                                    gp, tc::smem_u32(&full[r % slots]));
  };

  if (tid < slots) tc::mbar_init(&full[tid]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (copier) {
    for (int r = 0; r < slots - 1; ++r) issue(r);
  }
  tc::stage_queries<EB, Sh::BLOCK>(qsm, q_in, q0, nql, nt, d, tid);

  const tc::MmaRole mr = tc::mma_role<Sh::NPW, EB>(warp, lane, nt, d, gp, copy_only);
  const int splits = mr.splits, nt0 = mr.nt0, my_nt = mr.my_nt, split = mr.split;
  const int kc0 = mr.kc0, steps = mr.steps, a_off = mr.a_off;
  const uint32_t q_base = tc::smem_u32(qsm);
  const long long block_base = tile_base + (long long)warp * SUB_ROWS;
  const int col = warp * R;                      // block w's slab columns

  float s[QPT][LEV];
  int ix[QPT][LEV];                              // rows within the block
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
#pragma unroll
    for (int l = 0; l < LEV; ++l) {
      s[j][l] = -INFINITY;
      ix[j][l] = 0;
    }
  }

  for (int r = 0; r < RANKS; ++r) {
    tc::mbar_wait(tc::smem_u32(&full[r % slots]), (r / slots) & 1);
    __syncthreads();  // rank r landed; rank r-1's slot and the slab are free
    if (copier && r + slots - 1 < RANKS) issue(r + slots - 1);
    if (my_nt > 0) {
      tc::mma_rank<Row, C, QCAP>(
          tc::smem_u32(ring + (size_t)(r % slots) * slot_bytes) + a_off, q_base, slab, d,
          nt, lane, nt0, my_nt, split, kc0, steps);
    }
    __syncthreads();  // the slab of rank r is complete
    if (copy_only) continue;
    // every slab load in flight together (queries past the block's are
    // clamped, their states never written out); the 32 lanes read 32 slab
    // rows at one column, one bank each; k-splits add in split order
    float v[QPT][R];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const float* row = slab + min(lane + 32 * j, nt * 8 - 1) * LD + col;
#pragma unroll
      for (int i = 0; i < R; ++i) v[j][i] = row[i];
    }
#pragma unroll 1
    for (int p = 1; p < splits; ++p) {
      const float* part = slab + p * nt * 8 * LD + col;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const float* row = part + min(lane + 32 * j, nt * 8 - 1) * LD;
#pragma unroll
        for (int i = 0; i < R; ++i) v[j][i] += row[i];
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool live = block_base + r * R + i < n;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        evs::insert<LEV>(s[j], ix[j], live ? v[j][i] : evs::NEG_FILL, r * R + i);
      }
    }
  }
  if (copy_only) return;

  // lane-contiguous queries: each level's stores are coalesced
  const int b = blockIdx.x * BLOCKS_PER_TILE + warp;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qq = lane + 32 * j;
    if (qq < nql) {
      const size_t q = (size_t)(q0 + qq);
#pragma unroll
      for (int lvl = 0; lvl < LEV; ++lvl) out_s[((size_t)lvl * L + b) * nq + q] = s[j][lvl];
#pragma unroll
      for (int lvl = 0; lvl < LEV - 1; ++lvl) {
        // a level past the block's real rows names the block's first row
        out_i[((size_t)lvl * L + b) * nq + q] =
            b * SUB_ROWS + (s[j][lvl] == evs::NEG_FILL ? 0 : ix[j][lvl]);
      }
    }
  }
}

template <typename Row, int LEV, int QCAP>
int launch_shape(const void* emb, const float* q, int nq, int n, int d, int L,
                 float* out_s, int* out_i, int qc, int smem_max, cudaStream_t stream) {
  constexpr int C = rank_rows<Row>();
  const int slots = tc::ring_slots<Row, C, QCAP>(qc, d, false, smem_max);
  const int smem = (int)tc::smem_bytes<Row, C, QCAP>(slots, qc, d, false);
  const int err = evs::set_smem((const void*)block_tc_kernel<Row, C, LEV, QCAP>, smem);
  if (err) return err;
  const dim3 grid(L / BLOCKS_PER_TILE, (nq + qc - 1) / qc);
  block_tc_kernel<Row, C, LEV, QCAP><<<grid, tc::Shape<C, QCAP>::BLOCK, smem, stream>>>(
      static_cast<const Row*>(emb), q, nq, n, d, L, out_s, out_i, qc, slots);
  return (int)cudaGetLastError();
}

// Needs d % 64 == 0 and 1 <= nq <= 128, L = cdiv(n, 2048) * 8.
template <typename Row, int LEV>
int launch(const void* emb, const float* q, int nq, int n, int d, int L,
           float* out_s, int* out_i, cudaStream_t stream) {
  if (d % 64 || nq < 1 || nq > tc::MAX_QUERIES || L % BLOCKS_PER_TILE) {
    return (int)cudaErrorInvalidValue;
  }
  int smem_max = 0;
  const int err = tc::smem_limit(smem_max);
  if (err) return err;
  const int qc = tc::query_chunk<Row, rank_rows<Row>()>(nq, d, false, smem_max);
  if (!qc) return (int)cudaErrorInvalidValue;
  if (qc <= 8) {
    return launch_shape<Row, LEV, 8>(emb, q, nq, n, d, L, out_s, out_i, qc, smem_max, stream);
  }
  if constexpr (sizeof(Row) == 4) {  // at most 64 f32 queries a block
    return launch_shape<Row, LEV, 64>(emb, q, nq, n, d, L, out_s, out_i, qc, smem_max, stream);
  } else {
    if (qc <= 64) {
      return launch_shape<Row, LEV, 64>(emb, q, nq, n, d, L, out_s, out_i, qc, smem_max, stream);
    }
    return launch_shape<Row, LEV, tc::MAX_QUERIES>(emb, q, nq, n, d, L, out_s, out_i, qc,
                                                   smem_max, stream);
  }
}

template <int LEV>
int launch_dtype(const void* emb, int is_bf16, const float* q, int nq, int n, int d,
                 int L, float* out_s, int* out_i, cudaStream_t stream) {
  return is_bf16 ? launch<uint16_t, LEV>(emb, q, nq, n, d, L, out_s, out_i, stream)
                 : launch<float, LEV>(emb, q, nq, n, d, L, out_s, out_i, stream);
}

}  // namespace

// emb: (n, d) row-major, f32 (is_bf16 = 0) or bf16 bits (is_bf16 = 1),
// 16-byte aligned; q: (nq, d) f32, already rounded to bf16 for a bf16
// corpus. Returns the CUDA error code of the launch (0 = launched).
extern "C" int evs_topk_block(const void* emb, int is_bf16, const float* q,
                              int nq, int n, int d, int levels, int L,
                              float* out_s, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (levels == 3) return launch_dtype<3>(emb, is_bf16, q, nq, n, d, L, out_s, out_i, st);
  if (levels == 4) return launch_dtype<4>(emb, is_bf16, q, nq, n, d, L, out_s, out_i, st);
  return (int)cudaErrorInvalidValue;
}
