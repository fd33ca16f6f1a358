// Tensor-core candidate kernels. The residue-class kernel serves five users:
//   B1's bf16 path   (topk_tree.cu)  tc_kernel<uint16_t, RawDot>
//   B1's f32 path    (topk_tree.cu)  tc_kernel<float,    RawDot>
//   B3, the SQ8 sweep (topk_sq8.cu)  tc_kernel<int8_t,   Bound>
//   E1 bf16_struct    (topk_sq8.cu)  tc_kernel<uint16_t, Bound>
//   E1 int8_noscale   (topk_sq8.cu)  tc_kernel<int8_t,   RawDot>
// and B2 (topk_block.cu, block_tc_kernel, bf16 and f32 rows) walks 256-row
// blocks on the same three phases, held here once for both walks: the
// bulk copies of a rank's 8 row groups into the ring (issue_rank), the
// queries staged in shared memory (stage_queries) and the MMA phase into
// the dot slab (mma_role, mma_rank). Each walk keeps its own rows per
// rank, selection and epilogue.
// Row is the corpus element (bf16 bits, int8 or f32); Figure is what the
// selection ranks: the raw dot <row, q~> (q~ = bf16(q) for bf16 and int8
// rows, q itself for f32 rows), or the SQ8 bound dot*scale + ||q||*radd.
// For every (query, tile, residue class) the kernel emits the best two
// figures with their rows and the third-best figure, ties resolved as the
// reference's halving tree resolves them (below). Rows at or past n rank
// at NEG_FILL and keep their row number.
//
// What bounds it on an H100 at Q <= 128 and d = 512: the bytes, N*d*|Row|
// read once (plus 8*N of scale and radd for Bound) and the outputs
// (Q*tiles*(256*8 + 128*4)) written once, at 3.35 TB/s. The 2*Q*N*d
// products run on the tensor cores (mma.sync m16n8k16, bf16 x bf16 ->
// f32, 989 TFLOP/s): at most 128 products per bf16 corpus byte against the
// ~295 at which the tensor cores would set the pace (256 per int8 byte).
// f32 rows take three TF32 products each (m16n8k8, 495 TFLOP/s, below):
// 3*2*Q*N*d at Q = 48 is 72 TF32 products per corpus byte against ~148.
//
// Design:
//   1. dots on the tensor cores, fed by ldmatrix from conflict-free shared
//      memory;
//   2. one block serves every query of the launch (up to 128, padded to 8,
//      resident in shared memory as bf16, or up to 64 as f32), so the
//      corpus is read once; only above 64 f32 queries, or where d is so
//      wide that the queries and two ring slots do not fit, are the queries
//      cut into chunks, one corpus read each;
//   3. each block owns C contiguous classes of one tile (C = 32, or 16
//      where 32 would leave half the SMs idle, and always 16 for f32 rows,
//      whose 32-row slots would not fit twice beside 48 f32 queries at
//      d = 512), so one rank of the walk is C contiguous rows, staged by
//      bulk (TMA) copies completing on an mbarrier into a ring of 2-4
//      slots that keeps 1-3 ranks in flight while one is scored;
//   4. the MMA pads queries to 8 only, and d is split across the warps that
//      few queries would leave idle;
//   5. the block walks the tile's groups itself in the halving tree's rank
//      order (group_of_rank); each rank's (C x Q) dot slab goes to shared
//      memory, and thread (class, query slot) applies the Figure and
//      inserts it into a running top-3 held in registers, so ties resolve
//      in rank order with no merge.
//
// Residue classes. The corpus is cut into tiles of tile_rows rows; class j
// of tile t is the rows t*tile_rows + j + 128*g, g < G = tile_rows/128. The
// outputs are the reference's pre-packed layout:
//   cand_s, cand_i: (nq, tiles*256), tile t owning columns
//                   [t*256, t*256+128) = best, [t*256+128, t*256+256) = 2nd
//   m3:             (nq, tiles*128), the class's third-best figure
// The reference (evossearch_tpu/ops/topk_pallas.py:417-517) reduces each
// class with a halving tree whose figure-only merges prefer the left
// operand on ties: a balanced merge over the class's groups taken in the
// order rank(g) = 2*bitrev(g mod G/2) + (g >= G/2) (bitrev over log2(G/2)
// bits), which keeps the top two under (figure desc, rank asc) and the
// exact third value. The walk takes the groups in that order
// (group_of_rank inverts the formula) with strict ">" insertion, and so
// gives the reference's outputs bit for bit on ties too.
//
// int8 rows. int8 values widen to bf16 exactly (|v| <= 127 < 2^8), so the
// int8 path is the bf16 path on the same products. The ring holds the
// int8 bytes, half a bf16 slot, and one ldmatrix.x4 over int8 rows, read
// as b16 pairs, gives each thread 4 contiguous bytes of each 8x8 matrix:
// the A fragments of two m16n8k16 products (16 columns of rows g and g+8,
// twice). The fixed k order inside each 16-column group makes those bytes
// 4t..4t+3 the thread's logical columns {2t, 2t+1, 2t+8, 2t+9}; the
// queries are staged in shared memory in that same order (logical column
// s of a group holds query column K_ORDER[s]), so every product pairs a
// row byte with its own query value, and a dot is a sum over k whatever
// the order. Each fragment word widens once (an XOR bias, byte permutes
// into the mantissa of 2^23, one subtraction) and serves all of the warp's
// query tiles: the conversion is paid per row, not per (row, query tile).
//
// f32 rows (3xTF32). The reference scores f32 corpora at
// Precision.HIGHEST, three bf16 passes on its MXU (topk_pallas.py:94-100);
// here the passes are TF32 (10 stored mantissa bits against bf16's 7).
// The queries are staged unrounded, as f32 in 16-byte chunks of 4 columns,
// and one ldmatrix.x4 over f32 rows, read as b16 pairs, gives exactly one
// m16n8k8 A fragment: each 8x8 b16 matrix is 8 rows by 4 f32 columns, so
// thread (g = lane/4, t = lane%4) holds a0 = (row g, col t), a1 = (g+8, t),
// a2 = (g, t+4), a3 = (g+8, t+4); over the staged queries it holds the B
// fragments b0 = (k = t, query g), b1 = (k = t+4, query g) of two k8 steps.
// Each word x splits into big = x & 0xffffe000 (its top 11 significant
// bits, exact in TF32) and small = x - big (exact in f32), rounded to
// nearest TF32 (split_tf32). Three MMAs per k8 step, small*big, big*small
// and big*big, go into three accumulators (three dependent chains a third
// as long as one), joined as (small*big + big*small) + big*big;
// small*small is dropped. On exact-dot inputs (k/16, |k| <= 4) every
// small is 0, every product and sum is exact, and the kernel equals the
// plain version bit for bit. What bounds it on an H100: inside this
// kernel mma.sync sustains about a quarter of the card's 495 TFLOP/s of
// TF32, and the split's integer and f32 work per fragment word competes
// with the MMAs for issue slots (scripts/split_f32_time.py, PERF.md).
//
// Accumulation model (what the SQ8 certificate relies on). Products of
// int8 (or bf16) values and bf16 queries are exact in f32. The tensor
// cores do not promise IEEE round-to-nearest accumulation: published
// measurements of earlier NVIDIA tensor cores show each m16n8k16 summing
// its 16 products and the accumulator with truncation, an error of up to
// 2^-23 relative per addition, twice the serial round-to-nearest bound.
// The k-splits' partial sums are then added in split order with IEEE f32
// adds. The kernel relies on |dot - <e8, q~>| <= 2*d*2^-24*sum|e8*q~|
// (chip_smoke.py measures the worst ratio on the card and checks it is at
// most 2). quantize_rows (index/sq8.py) budgets the accumulation as
// 2*d*2^-24*scale*||e8||*||q|| (the serial bound, doubled to cover the host
// rerank too) inside anorm*(C_BF16 + 2*d*2^-24)*1.05. The 0.05*C_BF16*anorm
// = 0.05*2^-9*anorm of that inflation alone is 3.2*d*2^-24*anorm at d =
// 512 and 1.6*d*2^-24*anorm at d = 1024, so a truncating accumulation (one
// more d*2^-24*anorm*||q||) stays covered with radd's formula and the
// sidecar format unchanged (tests/test_torch_sq8_tc.py states the margin).
// Bound's two products and its sum are written with __fmul_rn/__fadd_rn
// so they cannot contract into an FMA: the plain version rounds each of
// the three, and on exact-dot inputs the two agree bit for bit.
// f32 rows, on the same hypothesis, for d <= 1024:
//   |s - <x, q>| <= (2^-19 + 2*d*2^-24) * sum|x_k*q_k|.
// The split loses at most 1.5*2^-20*|x_k*q_k| per product: rounding small
// to TF32 drops at most its two lowest bits, 2^-22 of |x| (and of |q|),
// and the dropped small*small is below 2^-20*|x_k*q_k|. The TF32 products
// are exact in f32. The big*big chain accumulates as above (2*d*2^-24);
// the small chains hold terms below 2^-10 of their product's, so their own
// truncation (2*2*d*2^-34) and the two adds joining the chains (about
// 2^-24) stay under the 2^-21 left over up to d = 1024
// (tests/test_torch_f32_tc.py holds a numpy model of it; chip_smoke.py
// measures the worst ratio on the card, f32_err_ratio_max, and checks it
// is at most 1).
#pragma once

#include "topk_common.cuh"

namespace evs {
namespace tc {

constexpr int THREADS = 256;                  // MMA and selection threads
constexpr int WARPS = THREADS / 32;
constexpr int MAX_QUERIES = 128;              // LANES of ops/topk.py
constexpr int MAX_SLOTS = 4;                  // ring slots, at most
constexpr int CLASSES = 128;                  // residue classes of a tile
constexpr int MIN_TILE_ROWS = 4 * CLASSES;    // G >= 4: half_bits >= 1

// The group at rank r of the halving tree's order, half_bits = log2(G/2)
// >= 1: the low bit of r picks the half, the rest is the bit-reversed group.
__device__ __forceinline__ int group_of_rank(int r, int half_bits) {
  const int low = (int)(__brev((unsigned)(r >> 1)) >> (32 - half_bits));
  return ((r & 1) << half_bits) + low;
}

// log2(G/2) for a power-of-two tile of at least MIN_TILE_ROWS rows.
inline int class_half_bits(int tile_rows) {
  int half_bits = 0;
  while ((CLASSES << (half_bits + 1)) < tile_rows) ++half_bits;
  return half_bits;
}

// Bytes of one staged query element: f32 rows take f32 queries, the
// others bf16.
template <typename Row>
__host__ __device__ constexpr int query_bytes() {
  return sizeof(Row) == 4 ? 4 : 2;
}

// ---- Figures ---------------------------------------------------------------

// The raw dot <row, q~> (B1, E1 int8_noscale).
struct RawDot {
  static constexpr bool NORMS = false;  // reads no scalars, no query norms
  __device__ __forceinline__ float operator()(float dot, float) const { return dot; }
};

// B3's certified upper bound dot*scale + ||q||*radd (B3, E1 bf16_struct),
// written as topk_pallas.py:560-573 and the plain version round it.
struct Bound {
  static constexpr bool NORMS = true;
  float sc = 0.f, ra = 0.f;
  // scale and radd of a live row: scal2 = [scale (n); radd (n)]
  __device__ __forceinline__ void fetch(const float* __restrict__ scal2, int n,
                                        long long row) {
    sc = __ldg(scal2 + row);
    ra = __ldg(scal2 + n + row);
  }
  __device__ __forceinline__ float operator()(float dot, float qn) const {
    return __fadd_rn(__fmul_rn(dot, sc), __fmul_rn(qn, ra));
  }
};

// ---- device helpers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk ``ch`` of query ``q`` in the shared
// query tile: the chunk index is XORed with the query's low 3 bits, so
// the 8 queries one ldmatrix phase reads sit in 8 different bank groups.
__device__ __forceinline__ int chunk_off(int q, int ch, int d) {
  return q * d + ((ch ^ (q & 7)) << 3);
}

// Float offset of 16-byte chunk ``ch`` (4 columns) of f32 query ``q``,
// swizzled the same way.
__device__ __forceinline__ int chunk_off_f32(int q, int ch, int d) {
  return q * d + ((ch ^ (q & 7)) << 2);
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

// c += a (16x8 tf32, rows) * b (8x8 tf32, queries), f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The f32 bits x as big + small: big its top 11 significant bits (exact
// in TF32), small = x - big (exact in f32) rounded to TF32, to nearest
// with ties away from zero as cvt.rna.tf32.f32 rounds, by an integer add
// and mask (cvt ran the f32 kernels markedly slower on an H100).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big, uint32_t& small) {
  big = x & 0xffffe000u;
  const float rest = __fsub_rn(__uint_as_float(x), __uint_as_float(big));
  small = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

// Four int8 values (bytes 0-3 of w) widened exactly to two bf16 pairs, lo
// = (byte 0, byte 1), hi = (byte 2, byte 3), the first of each pair in
// the low half: each byte, biased to x + 128, becomes the low mantissa
// byte of 2^23, the subtraction of 2^23 + 128 leaves x exactly, and an
// integer of at most 8 bits is its f32's top half.
__device__ __forceinline__ void widen_i8(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr uint32_t TWO23 = 0x4b000000u;
  constexpr float BIAS = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, TWO23, 0x7650)) - BIAS;
  const float f1 = __uint_as_float(__byte_perm(u, TWO23, 0x7651)) - BIAS;
  const float f2 = __uint_as_float(__byte_perm(u, TWO23, 0x7652)) - BIAS;
  const float f3 = __uint_as_float(__byte_perm(u, TWO23, 0x7653)) - BIAS;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
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

// ---- shapes ----------------------------------------------------------------

// Compile-time shape of a block of C classes serving at most QCAP queries.
template <int C, int QCAP>
struct Shape {
  static constexpr int M_TILES = C / 16;                 // 16-row MMA tiles
  static constexpr int NPW = QCAP >= 64 ? 4 : 1;        // query tiles per warp
  static constexpr int SLOTS = THREADS / C;              // query slots
  static constexpr int QPT = (QCAP + SLOTS - 1) / SLOTS; // queries per thread
  static constexpr int LD = C + 1;                       // slab row pitch
  // a ninth warp for the copies, where its registers can be spared: nine
  // warps leave 224 registers a thread, which the 128-query state exceeds
  static constexpr bool COPY_WARP = QCAP <= 64;
  static constexpr int BLOCK = THREADS + (COPY_WARP ? 32 : 0);
  // slab rows: k-splits x query tiles x 8 <= NPW * WARPS * 8
  static constexpr int SLAB_ROWS =
      NPW * WARPS * 8 > QCAP ? NPW * WARPS * 8 : QCAP;
};

// A ring slot holds the C rows of one rank as 8 groups of C/8 rows (one
// bulk copy each), 16 bytes of pad between groups. An ldmatrix phase
// reads one row of each group, so its 8 rows fall in 8 different bank
// groups (C/8*d*|Row| % 128 == 0): the MMA's 16-row tile mt takes rows w =
// 2*mt (M index 0-7) and 2*mt + 1 (8-15) of every group, and the slab
// holds row i of group w in column w*C/8 + i. Group pitch in bytes.
template <typename Row>
__host__ __device__ inline int group_pitch(int c, int d) {
  return c / 8 * d * (int)sizeof(Row) + 16;
}

// Shared memory of one block: qc queries (bf16, or f32 for f32 rows,
// swizzled), s ring slots, the (SLAB_ROWS, C + 1) f32 dot slab, then qc
// query norms (if norms).
template <typename Row, int C, int QCAP>
size_t smem_bytes(int s, int qc, int d, bool norms) {
  using Sh = Shape<C, QCAP>;
  return (size_t)qc * d * query_bytes<Row>() + (size_t)s * 8 * group_pitch<Row>(C, d) +
         (size_t)Sh::SLAB_ROWS * Sh::LD * 4 + (norms ? (size_t)qc * 4 : 0);
}

// Arguments of one launch. emb: (n, d) Row, 16-byte aligned; scal2: (2, n)
// f32 [scale; radd] and qn: (nq,) f32 norms of the unrounded queries, for
// Bound only; q: (nq, d) f32, already rounded to bf16 for bf16 and int8
// rows.
struct Args {
  const void* emb;
  const float* scal2;
  const float* q;
  const float* qn;
  int nq, n, d, tile_rows;
  float* cand_s;
  int* cand_i;
  float* m3;
};

// ---- phases shared by the walks --------------------------------------------

// Copies of one rank into the ring slot at shared address ``dst``: group
// w is the C/8 = R rows from row g0 + w*GSTRIDE (fewer at the corpus end,
// none past it), one bulk copy by copier thread cw = w into the group's
// place in the slot. Copier thread 0 posts the bytes of the rank's
// ``rows`` live rows (all 8 groups) as the barrier's one arrival, so a
// rank with none completes at once.
template <int EB, int R, int GSTRIDE>
__device__ __forceinline__ void issue_rank(const unsigned char* __restrict__ emb,
                                           long long g0, int rows, int n, int d,
                                           int cw, uint32_t dst, int gp, uint32_t bar) {
  if (cw == 0) mbar_expect(bar, rows * d * EB);
  int mine;  // group cw's live rows
  if constexpr (GSTRIDE == R) {
    mine = min(R, rows - cw * R);  // contiguous groups: the rank's first rows
  } else {
    mine = (int)max(0LL, min((long long)R, (long long)n - (g0 + cw * GSTRIDE)));
  }
  if (cw < 8 && mine > 0) {
    bulk_copy(dst + cw * gp, emb + (g0 + cw * GSTRIDE) * d * EB, mine * d * EB, bar);
  }
}

// The block's nql queries from q0 as bf16 into qsm (they arrive rounded:
// the top halves of the f32 bit patterns), zero past nql up to the
// 8-query tile; for int8 rows in the k order of each 16-column group,
// K_ORDER = {0, 1, 4, 5, 8, 9, 12, 13 | 2, 3, 6, 7, 10, 11, 14, 15}: chunk
// 2m + h of a group holds its columns 4i + 2h + {0, 1}, i < 4. For f32
// rows (EB = 4) the queries stay f32, unrounded, 4 columns a chunk.
template <int EB, int BLOCK>
__device__ __forceinline__ void stage_queries_b16(uint16_t* qsm, const float* __restrict__ q,
                                                  int q0, int nql, int nt, int d, int tid) {
  const int chunks = d >> 3;  // 8-column query chunks
  for (int u = tid; u < nt * 8 * chunks; u += BLOCK) {
    const int qq = u / chunks, ch = u % chunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (qq < nql) {
      const float* p = q + (size_t)(q0 + qq) * d;
      float x[8];
      if constexpr (EB == 2) {
        const float4 s = __ldg(reinterpret_cast<const float4*>(p + ch * 8));
        const float4 t = __ldg(reinterpret_cast<const float4*>(p + ch * 8) + 1);
        x[0] = s.x; x[1] = s.y; x[2] = s.z; x[3] = s.w;
        x[4] = t.x; x[5] = t.y; x[6] = t.z; x[7] = t.w;
      } else {
        const float* grp = p + (ch >> 1) * 16 + 2 * (ch & 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 s = __ldg(reinterpret_cast<const float2*>(grp + 4 * i));
          x[2 * i] = s.x;
          x[2 * i + 1] = s.y;
        }
      }
      v.x = (__float_as_uint(x[1]) & 0xffff0000u) | (__float_as_uint(x[0]) >> 16);
      v.y = (__float_as_uint(x[3]) & 0xffff0000u) | (__float_as_uint(x[2]) >> 16);
      v.z = (__float_as_uint(x[5]) & 0xffff0000u) | (__float_as_uint(x[4]) >> 16);
      v.w = (__float_as_uint(x[7]) & 0xffff0000u) | (__float_as_uint(x[6]) >> 16);
    }
    *reinterpret_cast<uint4*>(qsm + chunk_off(qq, ch, d)) = v;
  }
}

template <int EB, int BLOCK>
__device__ __forceinline__ void stage_queries(uint16_t* qsm, const float* __restrict__ q,
                                              int q0, int nql, int nt, int d, int tid) {
  if constexpr (EB == 4) {
    float* qf = reinterpret_cast<float*>(qsm);
    const int chunks = d >> 2;  // 4-column f32 chunks
    for (int u = tid; u < nt * 8 * chunks; u += BLOCK) {
      const int qq = u / chunks, ch = u % chunks;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qq < nql) v = __ldg(reinterpret_cast<const float4*>(q + (size_t)(q0 + qq) * d) + ch);
      *reinterpret_cast<float4*>(qf + chunk_off_f32(qq, ch, d)) = v;
    }
  } else {
    stage_queries_b16<EB, BLOCK>(qsm, q, q0, nql, nt, d, tid);
  }
}

// The MMA phase of one warp: each warp owns every 16-row tile of the
// block, a run of up to NPW 8-query tiles and a share of d, so each query
// fragment is read from shared memory once per rank (on an H100 the
// ldmatrix traffic, not the tensor cores, set the pace of this phase).
// Few queries leave query tiles for few warps, so d is cut into as many
// k-splits as keep all 8 warps busy (a split spans a multiple of 32
// columns); the splits' partial dots go to their own slab rows (split p's
// at slab + p*nt*8*LD) and the selection adds them in split order, so
// results do not depend on timing. Each warp loads the next 32 columns'
// fragments before it multiplies the current ones.
//
// The role (mma_role) is unpacked into the kernel's own values and the
// phase (mma_rank) takes them as arguments: held as a struct with the
// phase as its method, the same code ran B3's bound figure up to 5%
// slower at Q = 48 on an H100 (PERF.md).
struct MmaRole {
  int splits;  // k-splits of d
  int nt0;     // the warp's first 8-query tile
  int my_nt;   // its query tiles (0: the copy warp, or no tile left)
  int split;   // its k-split
  int kc0;     // the split's first 8-column query chunk
  int steps;   // the split's 32-column steps
  int a_off;   // the lane's ldmatrix offset into a ring slot
};

template <int NPW, int EB>
__device__ __forceinline__ MmaRole mma_role(int warp, int lane, int nt, int d, int gp,
                                            bool idle) {
  const int chunks = d >> 3;
  int splits = WARPS;
  while (splits > 1 && (chunks % (4 * splits) || nt > NPW * (WARPS / splits))) {
    splits >>= 1;
  }
  const int wcols = WARPS / splits;               // warps across query tiles
  const int npw = (nt + wcols - 1) / wcols;
  const int nt0 = warp % wcols * npw;
  const int split = warp / wcols;
  // ldmatrix lanes: A (rows) x4 = M index 0-7 / 8-15 x 16 bytes +0 / +16
  // (bf16: columns +0 / +8 of one k16 step; int8: the 16-column groups
  // +0 / +16, two k16 steps; f32: columns +0 / +4 of one k8 step), M index
  // m of tile mt being row 2*mt + m/8 of group m%8
  return {splits, nt0, idle ? 0 : max(0, min(npw, nt - nt0)), split,
          split * (chunks / splits), chunks / splits / 4,
          (lane & 7) * gp + ((lane >> 3) & 1) * d * EB + (lane >> 4) * 16};
}

// mma_rank for f32 rows, in 16-column half steps (two k8 steps): A is
// one x4 per k8 step, B one x4 per query tile (8 queries x f32 chunks
// +0..+3); every word is split once (split_tf32) and serves the three
// passes. Half steps keep the double-buffered fragments to 8 + 4*NPW
// words: the 32-column steps of mma_rank_b16 spilled registers at 64
// queries, whose block (with its copy warp) may hold 168 a thread.
template <int C, int QCAP>
__device__ __forceinline__ void mma_rank_tf32(uint32_t a_base, uint32_t q_base, float* slab,
                                              int d, int nt, int lane, int nt0, int my_nt,
                                              int split, int kc0, int steps) {
  using Sh = Shape<C, QCAP>;
  constexpr int NPW = Sh::NPW, LD = Sh::LD, MT = Sh::M_TILES;
  constexpr int R = C / 8;                       // rows per group
  const int b_row = lane & 7;
  const int b_ch = lane >> 3;
  // accumulators of the three passes: [0] big*big, [1] small*big,
  // [2] big*small
  float acc[3][MT][NPW][4];
  // A words [k8 step][4]; B words [b0, b1 of k8 step 0, b0, b1 of step 1]
  uint32_t fa[2][MT][2][4], fb[2][NPW][4];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        acc[p][m][i][0] = acc[p][m][i][1] = acc[p][m][i][2] = acc[p][m][i][3] = 0.f;
      }
    }
  }
  // fragments of the 16 columns from 8-column chunk k into buffer b
  auto load = [&](int k, int b) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint32_t at = a_base + 2 * m * d * 4 + k * 32;
      ldsm_x4(at, fa[b][m][0]);
      ldsm_x4(at + 32, fa[b][m][1]);
    }
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      if (i < my_nt) {
        ldsm_x4(q_base + 4 * chunk_off_f32((nt0 + i) * 8 + b_row, 2 * k + b_ch, d), fb[b][i]);
      }
    }
  };
  auto multiply = [&](int b) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(fa[b][m][s][e], ab[m][e], as[m][e]);
      }
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        if (i < my_nt) {
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(fb[b][i][2 * s], bb0, bs0);
          split_tf32(fb[b][i][2 * s + 1], bb1, bs1);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_tf32(acc[1][m][i], as[m], bb0, bb1);
            mma_tf32(acc[2][m][i], ab[m], bs0, bs1);
            mma_tf32(acc[0][m][i], ab[m], bb0, bb1);
          }
        }
      }
    }
  };
  const int halves = 2 * steps;
  load(kc0, 0);
  for (int t = 0; t < halves; t += 2) {
    load(kc0 + 2 * (t + 1), 1);
    multiply(0);
    if (t + 2 < halves) load(kc0 + 2 * (t + 2), 0);
    multiply(1);
  }
  // (small*big + big*small) + big*big, then the slab as in mma_rank
  float* part = slab + (size_t)split * nt * 8 * LD + (lane >> 2) * R;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      if (i < my_nt) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = __fadd_rn(__fadd_rn(acc[1][m][i][e], acc[2][m][i][e]), acc[0][m][i][e]);
        }
        const int qq = (nt0 + i) * 8 + 2 * (lane & 3);
        part[qq * LD + 2 * m] = v[0];
        part[(qq + 1) * LD + 2 * m] = v[1];
        part[qq * LD + 2 * m + 1] = v[2];
        part[(qq + 1) * LD + 2 * m + 1] = v[3];
      }
    }
  }
}

// mma_rank for bf16 and int8 rows.
template <typename Row, int C, int QCAP>
__device__ __forceinline__ void mma_rank_b16(uint32_t a_base, uint32_t q_base, float* slab,
                                             int d, int nt, int lane, int nt0, int my_nt,
                                             int split, int kc0, int steps) {
  using Sh = Shape<C, QCAP>;
  constexpr int NPW = Sh::NPW, LD = Sh::LD;
  constexpr int EB = sizeof(Row);                // bytes per corpus element
  constexpr int R = C / 8;                       // rows per group
  const int b_row = lane & 7;
  const int b_ch = lane >> 3;
  float acc[Sh::M_TILES][NPW][4];
  // A words: bf16 [k16 step][4]; int8 [0][4], the raw bytes of both
  uint32_t fa[2][Sh::M_TILES][2][4], fb[2][NPW][4];
#pragma unroll
  for (int m = 0; m < Sh::M_TILES; ++m) {
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      acc[m][i][0] = acc[m][i][1] = acc[m][i][2] = acc[m][i][3] = 0.f;
    }
  }
  // fragments of the 32 columns from query chunk k into buffer b
  auto load = [&](int k, int b) {
#pragma unroll
    for (int m = 0; m < Sh::M_TILES; ++m) {
      const uint32_t at = a_base + 2 * m * d * EB + k * 8 * EB;
      ldsm_x4(at, fa[b][m][0]);
      if constexpr (EB == 2) ldsm_x4(at + 32, fa[b][m][1]);
    }
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      if (i < my_nt) {
        ldsm_x4(q_base + 2 * chunk_off((nt0 + i) * 8 + b_row, k + b_ch, d), fb[b][i]);
      }
    }
  };
  auto multiply = [&](int b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int m = 0; m < Sh::M_TILES; ++m) {
        uint32_t af[4];
        if constexpr (EB == 2) {
#pragma unroll
          for (int e = 0; e < 4; ++e) af[e] = fa[b][m][h][e];
        } else {
          // rows g / g+8 of 16-column group h: logical columns
          // {2t, 2t+1} (lo) and {2t+8, 2t+9} (hi)
          widen_i8(fa[b][m][0][2 * h], af[0], af[2]);
          widen_i8(fa[b][m][0][2 * h + 1], af[1], af[3]);
        }
#pragma unroll
        for (int i = 0; i < NPW; ++i) {
          if (i < my_nt) {
            mma_bf16(acc[m][i], af, fb[b][i][2 * h], fb[b][i][2 * h + 1]);
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
  // split's rows of the slab, at the rows' slot positions
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

// The warp's dots of one rank (my_nt > 0): A rows from a_base (the ring
// slot plus the role's a_off), B queries from q_base (bf16: x4 = 8
// queries x chunks +0..+3, two k16 steps), into its split's rows of the
// slab.
template <typename Row, int C, int QCAP>
__device__ __forceinline__ void mma_rank(uint32_t a_base, uint32_t q_base, float* slab,
                                         int d, int nt, int lane, int nt0, int my_nt,
                                         int split, int kc0, int steps) {
  if constexpr (sizeof(Row) == 4) {
    mma_rank_tf32<C, QCAP>(a_base, q_base, slab, d, nt, lane, nt0, my_nt, split, kc0, steps);
  } else {
    mma_rank_b16<Row, C, QCAP>(a_base, q_base, slab, d, nt, lane, nt0, my_nt, split, kc0,
                               steps);
  }
}

// ---- the residue-class kernel ----------------------------------------------

// Block (tile, C classes from c0) x (query chunk): walks the tile's G
// groups in rank order; per rank, C rows x the chunk's queries on the
// tensor cores, then the Figure and the top-3 insertions.
//
// Copies: up to S - 1 ranks in flight; row group w of a rank is one bulk
// copy into the ring slot, whose mbarrier counts the bytes. A bulk copy
// holds its warp for hundreds of cycles, so where registers allow, a
// ninth warp issues them all (lane w, group w); else lane 0 of MMA warp w
// issues group w.
// Selection: thread (class, query slot) keeps the top-3 of its queries in
// registers; for Bound it loads its row's scale and radd before the MMA
// phase, so the loads land while the dots are made. QCAP sizes the code to
// the batch: on an H100, a few-query launch ran its phases markedly slower
// inside the unrolled code for 128 queries (PERF.md).
template <typename Row, typename Figure, int C, int QCAP>
__global__ void __launch_bounds__(Shape<C, QCAP>::BLOCK, 1)
tc_kernel(Args a, int half_bits, int qc, int slots) {
  using Sh = Shape<C, QCAP>;
  constexpr int SLOTS = Sh::SLOTS, QPT = Sh::QPT, LD = Sh::LD;
  constexpr int BLOCKS_PER_TILE = CLASSES / C;
  constexpr int EB = sizeof(Row);                // bytes per corpus element
  constexpr int R = C / 8;                       // rows per group

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_SLOTS];
  const unsigned char* __restrict__ emb = static_cast<const unsigned char*>(a.emb);
  const int n = a.n, d = a.d;
  const int gp = group_pitch<Row>(C, d);
  const int slot_bytes = 8 * gp;
  uint16_t* qsm = reinterpret_cast<uint16_t*>(smem);
  unsigned char* ring = smem + (size_t)qc * d * query_bytes<Row>();
  float* slab = reinterpret_cast<float*>(ring + (size_t)slots * slot_bytes);
  float* qns = slab + Sh::SLAB_ROWS * LD;        // Bound's query norms

  // the thread index, read once and kept in a register: left to itself,
  // nvcc re-reads it inside the rank loop, which cost B1 4-5% at Q = 48 on
  // an H100 (PERF.md)
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  const int warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x / BLOCKS_PER_TILE;
  const int c0 = (blockIdx.x % BLOCKS_PER_TILE) * C;
  const int q0 = blockIdx.y * qc;
  const int nql = min(qc, a.nq - q0);            // this block's queries
  const int nt = (nql + 7) >> 3;                 // their 8-query tiles
  const int groups = a.tile_rows / CLASSES;
  const long long tile_base = (long long)tile * a.tile_rows;

  // rank r: the C contiguous rows of classes c0.. in group g, group w of
  // the ring their rows w*R..; rows at or past n are not read (their
  // figures are replaced by NEG_FILL)
  const bool copier = Sh::COPY_WARP ? warp == WARPS : true;
  const int cw = Sh::COPY_WARP ? lane : (lane == 0 ? warp : 8);
  auto issue = [&](int r) {
    const int g = group_of_rank(r, half_bits);
    const long long row0 = tile_base + (long long)g * CLASSES + c0;
    const int rows = (int)max(0LL, min((long long)C, (long long)n - row0));
    issue_rank<EB, R, R>(emb, row0, rows, n, d, cw,
                         smem_u32(ring + (size_t)(r % slots) * slot_bytes), gp,
                         smem_u32(&full[r % slots]));
  };
  // the warps that only copy
  const bool copy_only = Sh::COPY_WARP && warp == WARPS;

  if (tid < slots) mbar_init(&full[tid]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (copier) {
    for (int r = 0; r < slots - 1; ++r) issue(r);
  }
  stage_queries<EB, Sh::BLOCK>(qsm, a.q, q0, nql, nt, d, tid);
  if constexpr (Figure::NORMS) {
    for (int u = tid; u < qc; u += Sh::BLOCK) qns[u] = u < nql ? a.qn[q0 + u] : 0.f;
  }

  const MmaRole mr = mma_role<Sh::NPW, EB>(warp, lane, nt, d, gp, copy_only);
  const int splits = mr.splits, nt0 = mr.nt0, my_nt = mr.my_nt, split = mr.split;
  const int kc0 = mr.kc0, steps = mr.steps, a_off = mr.a_off;
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
    Figure fig;
    if constexpr (Figure::NORMS) {
      const long long row =
          tile_base + (long long)group_of_rank(r, half_bits) * CLASSES + c0 + cls;
      if (!copy_only && row < n) fig.fetch(a.scal2, n, row);
    }
    mbar_wait(smem_u32(&full[r % slots]), (r / slots) & 1);
    __syncthreads();  // rank r landed; rank r-1's slot and the slab are free
    if (copier && r + slots - 1 < groups) issue(r + slots - 1);
    if (my_nt > 0) {
      mma_rank<Row, C, QCAP>(smem_u32(ring + (size_t)(r % slots) * slot_bytes) + a_off,
                             q_base, slab, d, nt, lane, nt0, my_nt, split, kc0, steps);
    }
    __syncthreads();  // the slab of rank r is complete
    if (copy_only) continue;
    const int g = group_of_rank(r, half_bits);
    const bool live = tile_base + (long long)g * CLASSES + c0 + cls < n;
    // no branch per query: every slab load of the thread is in flight
    // together (rows past the block's queries are clamped and their
    // states never written out), and the k-splits add in split order
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
      float f = v[j];
      if constexpr (Figure::NORMS) f = fig(f, qns[min(slot + SLOTS * j, nt * 8 - 1)]);
      top3(s1[j], s2[j], s3[j], g1[j], g2[j], live ? f : NEG_FILL, g);
    }
  }
  if (copy_only) return;

  const size_t tiles = gridDim.x / BLOCKS_PER_TILE;
  const size_t c_cols = tiles * 2 * CLASSES;
  const size_t m_cols = tiles * CLASSES;
  const int j_cls = c0 + cls;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qq = slot + SLOTS * j;
    if (qq < nql) {
      const size_t q = (size_t)(q0 + qq);
      const size_t c = q * c_cols + (size_t)tile * 2 * CLASSES + j_cls;
      a.cand_s[c] = s1[j];
      a.cand_i[c] = (int)(tile_base + g1[j] * CLASSES + j_cls);
      a.cand_s[c + CLASSES] = s2[j];
      a.cand_i[c + CLASSES] = (int)(tile_base + g2[j] * CLASSES + j_cls);
      a.m3[q * m_cols + (size_t)tile * CLASSES + j_cls] = s3[j];
    }
  }
}

// ---- launch ----------------------------------------------------------------

// Dynamic shared memory a block may opt in to on the current device, less
// the static barriers; returns the CUDA error code.
inline int smem_limit(int& smem_max) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  smem_max -= MAX_SLOTS * 8;
  return (int)e;
}

// Queries per block: all nq (padded to 8) where they fit beside two ring
// slots, else the widest multiple of 8 that does (one corpus read per
// chunk); at most 64 f32 queries (72 fit at d = 512: the cap spares f32
// rows a 128-query instantiation); 0 where not even 8 fit.
template <typename Row, int C>
int query_chunk(int nq, int d, bool norms, int smem_max) {
  auto fits = [&](int qc) {
    return smem_bytes<Row, C, MAX_QUERIES>(2, qc, d, norms) <= (size_t)smem_max;
  };
  constexpr int cap = sizeof(Row) == 4 ? 64 : MAX_QUERIES;
  int qc = (min(nq, cap) + 7) / 8 * 8;
  while (qc > 8 && !fits(qc)) qc -= 8;
  return fits(qc) ? qc : 0;
}

// Ring slots beside a chunk of qc queries: as many as fit, 2 to MAX_SLOTS.
template <typename Row, int C, int QCAP>
int ring_slots(int qc, int d, bool norms, int smem_max) {
  int slots = MAX_SLOTS;
  while (slots > 2 && smem_bytes<Row, C, QCAP>(slots, qc, d, norms) > (size_t)smem_max) {
    --slots;
  }
  return slots;
}

template <typename Row, typename Figure, int C, int QCAP>
int launch_shape(const Args& a, int qc, int smem_max, cudaStream_t stream) {
  const int slots = ring_slots<Row, C, QCAP>(qc, a.d, Figure::NORMS, smem_max);
  const int smem = (int)smem_bytes<Row, C, QCAP>(slots, qc, a.d, Figure::NORMS);
  const int err = set_smem((const void*)tc_kernel<Row, Figure, C, QCAP>, smem);
  if (err) return err;
  const int tiles = (a.n + a.tile_rows - 1) / a.tile_rows;
  const dim3 grid(tiles * (CLASSES / C), (a.nq + qc - 1) / qc);
  tc_kernel<Row, Figure, C, QCAP><<<grid, Shape<C, QCAP>::BLOCK, smem, stream>>>(
      a, class_half_bits(a.tile_rows), qc, slots);
  return (int)cudaGetLastError();
}

template <typename Row, typename Figure, int C>
int launch_c(const Args& a, int smem_max, cudaStream_t stream) {
  const int qc = query_chunk<Row, C>(a.nq, a.d, Figure::NORMS, smem_max);
  if (!qc) return (int)cudaErrorInvalidValue;
  if (qc <= 8) return launch_shape<Row, Figure, C, 8>(a, qc, smem_max, stream);
  if constexpr (sizeof(Row) == 4) {
    return launch_shape<Row, Figure, C, 64>(a, qc, smem_max, stream);
  } else {
    if (qc <= 64) return launch_shape<Row, Figure, C, 64>(a, qc, smem_max, stream);
    return launch_shape<Row, Figure, C, MAX_QUERIES>(a, qc, smem_max, stream);
  }
}

// Shape of the launch: C = 32 classes per block, or 16 where the tiles
// are so few that 16 still gives one wave of blocks (32 would leave over
// half of the SMs idle, as at 2^18 rows of bf16); f32 rows always 16.
// Needs d % 64 == 0, 1 <= nq <= 128 and a power-of-two tile_rows >= 512;
// returns the CUDA error code of the launch (0 = launched).
template <typename Row, typename Figure>
int launch(const Args& a, cudaStream_t stream) {
  if (a.d % 64 || a.nq < 1 || a.nq > MAX_QUERIES ||
      a.tile_rows < MIN_TILE_ROWS || (a.tile_rows & (a.tile_rows - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int err = smem_limit(smem_max);
  if (err) return err;
  if constexpr (sizeof(Row) == 4) {
    return launch_c<Row, Figure, 16>(a, smem_max, stream);
  } else {
    const int tiles = (a.n + a.tile_rows - 1) / a.tile_rows;
    return 2 * tiles * (CLASSES / 32) > sms ? launch_c<Row, Figure, 32>(a, smem_max, stream)
                                            : launch_c<Row, Figure, 16>(a, smem_max, stream);
  }
}

}  // namespace tc
}  // namespace evs
