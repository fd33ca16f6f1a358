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
// bf16 corpus (tree_tc_kernel): bf16 x bf16 products are exact in f32, so
// the dots run on the tensor cores (mma.sync m16n8k16, f32 accumulation,
// as the reference's MXU pass at Precision.DEFAULT). What bounds it on an
// H100 at Q <= 128 and d = 512: the bytes, N*d*2 read once plus the
// outputs (Q*tiles*(256*8 + 128*4)) written once, at 3.35 TB/s; the
// 2*Q*N*d tensor-core operations (989 TFLOP/s) take less, as the kernel
// does at most 128 operations per corpus byte against the ~295 at which
// the tensor cores would set the pace. The design answers the five losses
// of the CUDA-core design it replaced (PERF.md):
//   1. dots as f32 FMAs on the CUDA cores -> tensor cores, fed by ldmatrix
//      from conflict-free shared memory;
//   2. one corpus read per 16-query chunk -> one block serves every query
//      of the launch (up to 128, padded to 8, resident in shared memory as
//      bf16), so the corpus is read once; only where d is so wide that 128
//      queries and two ring slots do not fit (d > 512) are the queries cut
//      into chunks, one corpus read each;
//   3. scattered 16-byte loads per thread -> each block owns C contiguous
//      classes of one tile (C = 32, or 16 where 32 would leave half the
//      SMs idle),
//      so one rank of the walk is C contiguous rows (C*d*2 bytes), staged
//      by bulk (TMA) copies completing on an mbarrier into a ring of 2-4
//      slots that keeps 1-3 ranks in flight while one is scored;
//   4. a Q = 1 launch paid for 16 query lanes -> the MMA pads queries to
//      8 only, and d is split across the warps that few queries would
//      leave idle;
//   5. four rank segments per class merged with shuffles -> the block
//      walks the tile's groups itself in the halving tree's rank order
//      (group_of_rank); each rank's (C x Q) score slab goes to shared
//      memory, and thread (class, query slot) inserts it into a running
//      top-3 held in registers, so ties resolve in rank order with no
//      merge.
// Rows at or past n score -FLT_MAX and keep their row number.
//
// f32 corpus (tree_kernel): the tensor cores would round f32 inputs to
// TF32, so f32 stores keep IEEE f32 FMAs on the CUDA cores through
// topk_class.cuh's selection: 2*Q*N*d FMAs (67 TFLOP/s) against one read
// of the corpus per 16-query chunk.
// Times on the card beside the bounds: PERF.md (from chip_smoke.py).

#include "topk_class.cuh"

namespace {

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int TC_THREADS = 256;                  // MMA and selection threads
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int MAX_QUERIES = 128;                 // LANES of ops/topk.py
constexpr int MAX_SLOTS = 4;                     // ring slots, at most

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk ``ch`` of query ``q`` in the shared
// query tile: the chunk index is XORed with the query's low 3 bits, so
// the 8 queries one ldmatrix phase reads sit in 8 different bank groups.
__device__ __forceinline__ int chunk_off(int q, int ch, int d) {
  return q * d + ((ch ^ (q & 7)) << 3);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared.b64 [%0], 1;\n" :: "r"(smem_u32(bar)));
}

// One arrival that also expects ``bytes`` of bulk copies on the barrier.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      " WAIT:\n"
      " mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Bulk (TMA) copy of ``bytes`` from global to shared memory, completing on
// the barrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// c += a (16x16 bf16, rows) * b (16x8 bf16, queries), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Running top-3 in arrival (rank) order: strict ">" keeps an equal score
// that arrived earlier ahead. Only the best two keep their group.
__device__ __forceinline__ void top3(float& s1, float& s2, float& s3, int& g1,
                                     int& g2, float v, int g) {
  const bool b1 = v > s1, b2 = v > s2, b3 = v > s3;
  s3 = b2 ? s2 : (b3 ? v : s3);
  s2 = b1 ? s1 : (b2 ? v : s2);
  g2 = b1 ? g1 : (b2 ? g : g2);
  s1 = b1 ? v : s1;
  g1 = b1 ? g : g1;
}

// Compile-time shape of a block of C classes serving at most QCAP queries.
template <int C, int QCAP>
struct TcShape {
  static constexpr int M_TILES = C / 16;                 // 16-row MMA tiles
  static constexpr int NPW = QCAP >= 64 ? 4 : 1;        // query tiles per warp
  static constexpr int SLOTS = TC_THREADS / C;           // query slots
  static constexpr int QPT = (QCAP + SLOTS - 1) / SLOTS; // queries per thread
  static constexpr int LD = C + 1;                       // slab row pitch
  // a ninth warp for the copies, where its registers can be spared: nine
  // warps leave 168 registers a thread, which the 128-query state exceeds
  static constexpr bool COPY_WARP = QCAP <= 64;
  static constexpr int BLOCK = TC_THREADS + (COPY_WARP ? 32 : 0);
  // slab rows: k-splits x query tiles x 8 <= NPW * TC_WARPS * 8
  static constexpr int SLAB_ROWS =
      NPW * TC_WARPS * 8 > QCAP ? NPW * TC_WARPS * 8 : QCAP;
};

// A ring slot holds the C rows of one rank as 8 groups of C/8 contiguous
// rows (one bulk copy each), 16 bytes of pad between groups. An ldmatrix
// phase reads one row of each group, so its 8 rows fall in 8 different
// bank groups (d % 64 == 0): the MMA's 16-row tile mt takes rows
// w = 2*mt (M index 0-7) and 2*mt + 1 (8-15) of every group.
__host__ __device__ inline int group_pitch(int c, int d) { return c / 8 * d + 8; }

// Shared memory of one block: qc queries (bf16, swizzled), S ring slots,
// then the (SLAB_ROWS, C + 1) f32 score slab.
template <int C, int QCAP>
size_t tc_smem(int s, int qc, int d) {
  using Sh = TcShape<C, QCAP>;
  return (size_t)qc * d * 2 + (size_t)s * 8 * group_pitch(C, d) * 2 +
         (size_t)Sh::SLAB_ROWS * Sh::LD * 4;
}

// Block (tile, C classes from c0) x (query chunk): walks the tile's G
// groups in rank order; per rank, C rows x the chunk's queries on the
// tensor cores, then the top-3 insertions.
//
// Copies: up to S - 1 ranks in flight; row group w of a rank is one bulk
// copy into the ring slot, whose mbarrier counts the bytes. A bulk copy
// holds its warp for hundreds of cycles, so where registers allow, a
// ninth warp issues them all (lane w, group w); else lane 0 of MMA warp w
// issues group w.
// MMA: each warp owns every 16-row tile of the block, a run of up to NPW
// 8-query tiles and a share of d, so each query fragment is read from
// shared memory once per rank (on an H100 the ldmatrix traffic, not the
// tensor cores, set the pace of this phase). Few queries leave query tiles for few
// warps, so d is cut into as many k-splits as keep all 8 warps busy (a
// split spans a multiple of 32 columns); the splits' partial scores go to
// their own slab rows and the selection adds them in split order, so
// results do not depend on timing. Each warp loads the next 32 columns'
// fragments before it multiplies the current ones.
// Selection: thread (class, query slot) keeps the top-3 of its queries in
// registers. QCAP sizes the code to the batch: on an H100, a few-query
// launch ran its phases markedly slower inside the unrolled code for 128
// queries (PERF.md).
template <int C, int QCAP>
__global__ void __launch_bounds__(TcShape<C, QCAP>::BLOCK, 1)
tree_tc_kernel(const uint16_t* __restrict__ emb, const float* __restrict__ q_in,
               int nq, int n, int d, int tile_rows, int half_bits, int qc,
               int slots, float* __restrict__ cand_s, int* __restrict__ cand_i,
               float* __restrict__ m3) {
  using Sh = TcShape<C, QCAP>;
  constexpr int NPW = Sh::NPW, SLOTS = Sh::SLOTS, QPT = Sh::QPT, LD = Sh::LD;
  constexpr int BLOCKS_PER_TILE = evs::CLASSES / C;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_SLOTS];
  constexpr int R = C / 8;                       // rows per group
  const int gp = group_pitch(C, d);
  const int slot_elems = 8 * gp;
  uint16_t* qsm = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ring = qsm + (size_t)qc * d;
  float* slab = reinterpret_cast<float*>(ring + (size_t)slots * slot_elems);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x / BLOCKS_PER_TILE;
  const int c0 = (blockIdx.x % BLOCKS_PER_TILE) * C;
  const int q0 = blockIdx.y * qc;
  const int nql = min(qc, nq - q0);              // this block's queries
  const int nt = (nql + 7) >> 3;                 // their 8-query tiles
  const int groups = tile_rows / evs::CLASSES;
  const long long tile_base = (long long)tile * tile_rows;
  const int chunks = d >> 3;                     // 16-byte chunks per row

  // bulk-copy the C rows of rank r into ring slot r % slots, group w by
  // copier thread w (the copy warp's lanes, or lane 0 of each MMA warp),
  // the expected bytes posted by copier thread 0; rows at or past n are not
  // read (their scores are replaced by NEG_FILL)
  const bool copier = Sh::COPY_WARP ? warp == TC_WARPS : true;
  const int cw = Sh::COPY_WARP ? lane : (lane == 0 ? warp : 8);
  auto issue = [&](int r) {
    const int g = evs::group_of_rank(r, half_bits);
    const long long row0 = tile_base + (long long)g * evs::CLASSES + c0;
    const int rows = (int)max(0LL, min((long long)C, (long long)n - row0));
    const uint32_t bar = smem_u32(&full[r % slots]);
    if (cw == 0) mbar_expect(bar, rows * d * 2);
    const int mine = min(R, rows - cw * R);
    if (cw < 8 && mine > 0) {
      bulk_copy(smem_u32(ring + (size_t)(r % slots) * slot_elems + cw * gp),
                emb + (row0 + cw * R) * d, mine * d * 2, bar);
    }
  };
  // the warps that only copy
  const bool copy_only = Sh::COPY_WARP && warp == TC_WARPS;

  if (tid < slots) mbar_init(&full[tid]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (copier) {
    for (int r = 0; r < slots - 1; ++r) issue(r);
  }
  // the chunk's queries as bf16 (they arrive rounded: the top halves of
  // the f32 bit patterns), zero past nql up to the 8-query tile
  for (int u = tid; u < nt * 8 * chunks; u += Sh::BLOCK) {
    const int qq = u / chunks, ch = u % chunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (qq < nql) {
      const float4* p =
          reinterpret_cast<const float4*>(q_in + (size_t)(q0 + qq) * d + ch * 8);
      const float4 x = __ldg(p), y = __ldg(p + 1);
      v.x = (__float_as_uint(x.y) & 0xffff0000u) | (__float_as_uint(x.x) >> 16);
      v.y = (__float_as_uint(x.w) & 0xffff0000u) | (__float_as_uint(x.z) >> 16);
      v.z = (__float_as_uint(y.y) & 0xffff0000u) | (__float_as_uint(y.x) >> 16);
      v.w = (__float_as_uint(y.w) & 0xffff0000u) | (__float_as_uint(y.z) >> 16);
    }
    *reinterpret_cast<uint4*>(qsm + chunk_off(qq, ch, d)) = v;
  }

  // MMA role: warp -> (run of query tiles, k-split)
  int splits = TC_WARPS;
  while (splits > 1 && (chunks % (4 * splits) || nt > NPW * (TC_WARPS / splits))) {
    splits >>= 1;
  }
  const int wcols = TC_WARPS / splits;            // warps across query tiles
  const int npw = (nt + wcols - 1) / wcols;
  const int nt0 = warp % wcols * npw;
  const int my_nt = copy_only ? 0 : max(0, min(npw, nt - nt0));
  const int split = warp / wcols;
  const int kc0 = split * (chunks / splits);      // this split's first chunk
  const int steps = chunks / splits / 4;          // its 32-column steps
  // ldmatrix lanes: A (rows) x4 = M index 0-7 / 8-15 x chunks +0 / +1,
  // M index m of tile mt being row 2*mt + m/8 of group m%8; B (queries) x4
  // = 8 queries x chunks +0..+3 (two k16 steps)
  const int a_off = 2 * ((lane & 7) * gp + ((lane >> 3) & 1) * d + (lane >> 4) * 8);
  const int b_row = lane & 7;
  const int b_ch = lane >> 3;
  const uint32_t q_base = smem_u32(qsm);
  // selection role: thread -> class c0 + cls, queries slot + SLOTS * j
  const int cls = tid % C;
  const int slot = tid / C;

  float s1[QPT], s2[QPT], s3[QPT];
  int g1[QPT], g2[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    s1[j] = s2[j] = s3[j] = -INFINITY;
    g1[j] = g2[j] = 0;
  }

  for (int r = 0; r < groups; ++r) {
    mbar_wait(smem_u32(&full[r % slots]), (r / slots) & 1);
    __syncthreads();  // rank r landed; rank r-1's slot and the slab are free
    if (copier && r + slots - 1 < groups) issue(r + slots - 1);

    if (my_nt > 0) {
      const uint32_t a_base =
          smem_u32(ring + (size_t)(r % slots) * slot_elems) + a_off;
      float acc[Sh::M_TILES][NPW][4];
      uint32_t fa[2][Sh::M_TILES][2][4], fb[2][NPW][4];
#pragma unroll
      for (int m = 0; m < Sh::M_TILES; ++m) {
#pragma unroll
        for (int i = 0; i < NPW; ++i) {
          acc[m][i][0] = acc[m][i][1] = acc[m][i][2] = acc[m][i][3] = 0.f;
        }
      }
      // fragments of the 32 columns from chunk k into buffer b
      auto load = [&](int k, int b) {
#pragma unroll
        for (int m = 0; m < Sh::M_TILES; ++m) {
          ldsm_x4(a_base + 4 * m * d + 16 * k, fa[b][m][0]);
          ldsm_x4(a_base + 4 * m * d + 16 * (k + 2), fa[b][m][1]);
        }
#pragma unroll
        for (int i = 0; i < NPW; ++i) {
          if (i < my_nt) {
            ldsm_x4(q_base + 2 * chunk_off((nt0 + i) * 8 + b_row, k + b_ch, d),
                    fb[b][i]);
          }
        }
      };
      auto multiply = [&](int b) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int m = 0; m < Sh::M_TILES; ++m) {
#pragma unroll
            for (int i = 0; i < NPW; ++i) {
              if (i < my_nt) {
                mma_bf16(acc[m][i], fa[b][m][h], fb[b][i][2 * h], fb[b][i][2 * h + 1]);
              }
            }
          }
        }
      };
      load(kc0, 0);
      for (int t = 0; t < steps; t += 2) {
        if (t + 1 < steps) load(kc0 + 4 * (t + 1), 1);
        multiply(0);
        if (t + 1 < steps) {
          if (t + 2 < steps) load(kc0 + 4 * (t + 2), 0);
          multiply(1);
        }
      }
      // fragment (M index lane/4 (+8), queries 2*(lane%4) (+1)) -> this
      // split's rows of the slab, at the rows' class positions
      float* part = slab + (size_t)split * nt * 8 * LD + (lane >> 2) * R;
#pragma unroll
      for (int m = 0; m < Sh::M_TILES; ++m) {
#pragma unroll
        for (int i = 0; i < NPW; ++i) {
          if (i < my_nt) {
            const int qq = (nt0 + i) * 8 + 2 * (lane & 3);
            part[qq * LD + 2 * m] = acc[m][i][0];
            part[(qq + 1) * LD + 2 * m] = acc[m][i][1];
            part[qq * LD + 2 * m + 1] = acc[m][i][2];
            part[(qq + 1) * LD + 2 * m + 1] = acc[m][i][3];
          }
        }
      }
    }
    __syncthreads();  // the slab of rank r is complete
    if (copy_only) continue;
    // no branch per query: every slab load of the thread is in flight
    // together (rows past the block's queries are clamped and their
    // states never written out), and the k-splits add in split order
    const int g = evs::group_of_rank(r, half_bits);
    const bool live = tile_base + (long long)g * evs::CLASSES + c0 + cls < n;
    float v[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      v[j] = slab[min(slot + SLOTS * j, nt * 8 - 1) * LD + cls];
    }
#pragma unroll 1
    for (int p = 1; p < splits; ++p) {
      const float* part = slab + p * nt * 8 * LD + cls;
#pragma unroll
      for (int j = 0; j < QPT; ++j) v[j] += part[min(slot + SLOTS * j, nt * 8 - 1) * LD];
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      top3(s1[j], s2[j], s3[j], g1[j], g2[j], live ? v[j] : evs::NEG_FILL, g);
    }
  }
  if (copy_only) return;

  const size_t tiles = gridDim.x / BLOCKS_PER_TILE;
  const size_t c_cols = tiles * 2 * evs::CLASSES;
  const size_t m_cols = tiles * evs::CLASSES;
  const int j_cls = c0 + cls;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qq = slot + SLOTS * j;
    if (qq < nql) {
      const size_t q = (size_t)(q0 + qq);
      const size_t c = q * c_cols + (size_t)tile * 2 * evs::CLASSES + j_cls;
      cand_s[c] = s1[j];
      cand_i[c] = (int)(tile_base + g1[j] * evs::CLASSES + j_cls);
      cand_s[c + evs::CLASSES] = s2[j];
      cand_i[c + evs::CLASSES] = (int)(tile_base + g2[j] * evs::CLASSES + j_cls);
      m3[q * m_cols + (size_t)tile * evs::CLASSES + j_cls] = s3[j];
    }
  }
}

template <int C, int QCAP>
int launch_tc_shape(const uint16_t* emb, const float* q, int nq, int n, int d,
                    int tile_rows, int qc, int smem_max, float* cand_s,
                    int* cand_i, float* m3, cudaStream_t stream) {
  int slots = MAX_SLOTS;
  while (slots > 2 && tc_smem<C, QCAP>(slots, qc, d) > (size_t)smem_max) --slots;
  const int smem = (int)tc_smem<C, QCAP>(slots, qc, d);
  const int err = evs::set_smem((const void*)tree_tc_kernel<C, QCAP>, smem);
  if (err) return err;
  const int tiles = (n + tile_rows - 1) / tile_rows;
  const dim3 grid(tiles * (evs::CLASSES / C), (nq + qc - 1) / qc);
  tree_tc_kernel<C, QCAP><<<grid, TcShape<C, QCAP>::BLOCK, smem, stream>>>(
      emb, q, nq, n, d, tile_rows, evs::class_half_bits(tile_rows), qc, slots,
      cand_s, cand_i, m3);
  return (int)cudaGetLastError();
}

template <int C>
int launch_tc_c(const uint16_t* emb, const float* q, int nq, int n, int d,
                int tile_rows, int smem_max, float* cand_s, int* cand_i,
                float* m3, cudaStream_t stream) {
  // all queries in one chunk when they fit beside two ring slots, else the
  // widest multiple of 8 that does
  int qc = (nq + 7) / 8 * 8;
  while (qc > 8 && tc_smem<C, MAX_QUERIES>(2, qc, d) > (size_t)smem_max) qc -= 8;
  if (tc_smem<C, MAX_QUERIES>(2, qc, d) > (size_t)smem_max) {
    return (int)cudaErrorInvalidValue;
  }
  if (qc <= 8) {
    return launch_tc_shape<C, 8>(emb, q, nq, n, d, tile_rows, qc, smem_max,
                                 cand_s, cand_i, m3, stream);
  }
  if (qc <= 64) {
    return launch_tc_shape<C, 64>(emb, q, nq, n, d, tile_rows, qc, smem_max,
                                  cand_s, cand_i, m3, stream);
  }
  return launch_tc_shape<C, MAX_QUERIES>(emb, q, nq, n, d, tile_rows, qc,
                                         smem_max, cand_s, cand_i, m3, stream);
}

// Shape of the launch: C = 32 classes per block, or 16 where the tiles
// are so few that 16 still gives one wave of blocks (32 would leave over
// half of the SMs idle, as at 2^18 rows of bf16).
int launch_tc(const uint16_t* emb, const float* q, int nq, int n, int d,
              int tile_rows, float* cand_s, int* cand_i, float* m3,
              cudaStream_t stream) {
  if (d % 64 || nq < 1 || nq > MAX_QUERIES) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  smem_max -= MAX_SLOTS * 8;  // the static barriers
  const int tiles = (n + tile_rows - 1) / tile_rows;
  return 2 * tiles * (evs::CLASSES / 32) > sms
             ? launch_tc_c<32>(emb, q, nq, n, d, tile_rows, smem_max, cand_s, cand_i, m3, stream)
             : launch_tc_c<16>(emb, q, nq, n, d, tile_rows, smem_max, cand_s, cand_i, m3, stream);
}

// ---- f32: CUDA cores -------------------------------------------------------

struct DotFigure {
  const float* __restrict__ emb;
  int d;
  const float* __restrict__ qs;

  __device__ __forceinline__ void operator()(int row,
                                             float (&acc)[evs::QM]) const {
    evs::dot_row<float>(emb + (size_t)row * d, qs, d, acc);
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
  return is_bf16
             ? launch_tc(static_cast<const uint16_t*>(emb), q, nq, n, d,
                         tile_rows, cand_s, cand_i, m3, st)
             : launch_f32(static_cast<const float*>(emb), q, nq, n, d,
                          tile_rows, cand_s, cand_i, m3, st);
}
