// The modified ResNet's conv epilogues, one pass each.
//
// Replaces no Pallas kernel: the JAX package leaves these chains to XLA,
// which fuses elementwise chains itself. The port's plain versions
// (ops/rn_epilogue.py, called from models/resnet.py) run each chain as
// 4-11 separate PyTorch passes, most of them over float32 copies of the
// activations. Five entry points, each reading its bf16 inputs once and
// writing bf16 once, every intermediate in registers. With
// bn(x) = bf16(x * scale + shift), per channel in float32:
//
//   evs_rn_bn_relu         relu(bn(x)): the stem's BatchNorms, every
//                          block's bn1, and bn2 where the stride is 1.
//   evs_rn_bn_relu_pool    the 2x2 average pool (stride 2, floor) of
//                          relu(bn(x)): the stem's last, and bn2 of a
//                          stride-2 block; the un-pooled tensor is never
//                          written.
//   evs_rn_bn_add_relu     relu(bf16(bn(x) + r)): a tail block's bn3 and
//                          its residual r, the block's input.
//   evs_rn_bn_bn_add_relu  relu(bf16(bn(x) + bn'(y))): a down block's bn3
//                          and its shortcut conv's output y through the
//                          shortcut's own BatchNorm.
//   evs_rn_avg_pool        the 2x2 average pool of x: a stride-2 down
//                          block's shortcut, before its conv.
//
// Numerics: the plain ops' arithmetic, operation for operation, so the
// output is theirs bit for bit:
//   * BatchNorm multiplies, then adds (__fmul_rn, __fadd_rn: nvcc contracts
//     no multiply-add into an FMA that the plain ops do not have), and
//     rounds to bf16 to nearest even, as torch's cast does (cvt.rn.bf16.f32);
//   * the residual add is torch's bf16 add: float32 sum, one rounding;
//   * ReLU is torch.relu's launch_clamp_scalar: a NaN passes as it is,
//     anything else is fmaxf(v, 0) (so -0 and +0 go where torch sends them);
//   * a pool sums its window in float32 as torch's avg_pool2d NHWC frame
//     does: from 0 (so -0 + -0 ... gives +0), rows then columns, then
//     divides by the window's count (IEEE division).
//
// What bounds them on an H100: bytes, at 3.35 TB/s. The plain chains move
// 32 bytes an element (BatchNorm + ReLU), 38 (with the residual) and 12.5
// (a pool); these move 4, 6 (8 with the shortcut's BatchNorm) and 2.5, plus
// 8 bytes a channel of each BatchNorm's scale and shift. Their times beside
// that bound: PERF.md (chip_smoke.py, phase rn_epilogue).
//
// Design: pure streaming. Activations are channels-last, so 8 channels
// make one 16-byte vector (C % 8 == 0) and a vector never crosses a pixel.
// One resident grid (at least MIN_BLOCKS blocks a SM) walks the tensor
// in a grid-stride loop whose stride (the threads in use) is a multiple of the
// C / 8 vectors of a pixel, so each thread keeps one channel group: it
// loads that group's scale and shift once into registers. The elementwise
// kernels keep UNROLL vectors of each input a thread in flight, the pool
// kernels POOL_UNROLL output vectors (4 loads each: one thread owns 8
// channels of an output pixel and reads its 2x2 window). Single-use
// data is read and written with streaming hints (__ldcs, __stcs).
// Every launch is on the caller's stream; each entry point returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take, before launching anything).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;  // blocks a SM at least: <= 128 registers a thread
constexpr int UNROLL = 4;      // elementwise kernels: vectors of each input a thread in flight
constexpr int POOL_UNROLL = 2; // pool kernels: output vectors of a thread in flight

// What a chain adds before its ReLU.
constexpr int NO_RESIDUAL = 0;  // relu(bn(x))
constexpr int RESIDUAL = 1;     // relu(bn(x) + r)
constexpr int NORMED = 2;       // relu(bn(x) + bn'(y))

struct Affine {
  float s[8];
  float b[8];
};

__device__ __forceinline__ void load_affine(Affine& a, const float* __restrict__ scale,
                                            const float* __restrict__ shift, int cg) {
  const float4* s4 = reinterpret_cast<const float4*>(scale) + 2 * cg;
  const float4* b4 = reinterpret_cast<const float4*>(shift) + 2 * cg;
  const float4 s0 = __ldg(s4), s1 = __ldg(s4 + 1), b0 = __ldg(b4), b1 = __ldg(b4 + 1);
  a.s[0] = s0.x, a.s[1] = s0.y, a.s[2] = s0.z, a.s[3] = s0.w;
  a.s[4] = s1.x, a.s[5] = s1.y, a.s[6] = s1.z, a.s[7] = s1.w;
  a.b[0] = b0.x, a.b[1] = b0.y, a.b[2] = b0.z, a.b[3] = b0.w;
  a.b[4] = b1.x, a.b[5] = b1.y, a.b[6] = b1.z, a.b[7] = b1.w;
}

// Channel k (0..7) of a vector, as a float (bf16 -> float32 is exact).
__device__ __forceinline__ float lane(const uint4 v, int k) {
  const uint32_t w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
  return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ float bf16_value(uint32_t bits) { return __uint_as_float(bits << 16); }

// torch.relu of a bf16 value: NaN kept as it is, else fmaxf(v, 0), exact in bf16.
__device__ __forceinline__ uint32_t relu(uint32_t h) {
  const float v = bf16_value(h);
  return isnan(v) ? h : bf16_bits(fmaxf(v, 0.0f));
}

// bf16(x * s + b), rounded as the plain ops round it.
__device__ __forceinline__ uint32_t batch_norm(float x, float s, float b) {
  return bf16_bits(__fadd_rn(__fmul_rn(x, s), b));
}

// The chain's value for channel k of x's and r's vectors.
template <int RES>
__device__ __forceinline__ uint32_t chain(const uint4 x, const uint4 r, const Affine& a,
                                          const Affine& a2, int k) {
  uint32_t h = batch_norm(lane(x, k), a.s[k], a.b[k]);
  if constexpr (RES == RESIDUAL) {
    h = bf16_bits(__fadd_rn(bf16_value(h), lane(r, k)));
  } else if constexpr (RES == NORMED) {
    const uint32_t g = batch_norm(lane(r, k), a2.s[k], a2.b[k]);
    h = bf16_bits(__fadd_rn(bf16_value(h), bf16_value(g)));
  }
  return relu(h);
}

template <int RES>
__device__ __forceinline__ uint4 chain_vector(const uint4 x, const uint4 r, const Affine& a,
                                              const Affine& a2) {
  uint32_t o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = chain<RES>(x, r, a, a2, k);
  return make_uint4(o[0] | o[1] << 16, o[2] | o[3] << 16, o[4] | o[5] << 16, o[6] | o[7] << 16);
}

// grid-stride over vecs vectors; step (the threads in use) % cv == 0, so
// thread t owns channel group t % cv throughout.
template <int RES>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    rn_bn_kernel(const uint4* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ shift, const uint4* __restrict__ r,
                 const float* __restrict__ scale2, const float* __restrict__ shift2,
                 uint4* __restrict__ out, long long vecs, int cv, long long step) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= step) return;
  const int cg = static_cast<int>(t % cv);
  Affine a, a2;
  load_affine(a, scale, shift, cg);
  if constexpr (RES == NORMED) load_affine(a2, scale2, shift2, cg);
  for (long long v0 = t; v0 < vecs; v0 += UNROLL * step) {
    uint4 xv[UNROLL], rv[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const long long v = v0 + i * step;
      xv[i] = rv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (v < vecs) {
        xv[i] = __ldcs(x + v);
        if constexpr (RES != NO_RESIDUAL) rv[i] = __ldcs(r + v);
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const long long v = v0 + i * step;
      if (v < vecs) __stcs(out + v, chain_vector<RES>(xv[i], rv[i], a, a2));
    }
  }
}

// The 2x2 average of channel k over a window's four vectors (rows, then
// columns), each through relu(bn()) first when BN.
template <bool BN>
__device__ __forceinline__ uint32_t pool_lane(const uint4 (&win)[4], const Affine& a, int k) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = BN ? bf16_value(relu(batch_norm(lane(win[j], k), a.s[k], a.b[k])))
                       : lane(win[j], k);
    acc = __fadd_rn(acc, v);
  }
  return bf16_bits(__fdiv_rn(acc, 4.0f));
}

// grid-stride over pixels output pixels (ho x wo each image) of cv
// vectors; step % cv == 0, so thread t owns channel group t % cv of output
// pixels t / cv + i * (step / cv).
template <bool BN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    rn_pool_kernel(const uint4* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, uint4* __restrict__ out, int h, int w,
                   int ho, int wo, int cv, int pixels, int step) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= step) return;
  const int cg = t % cv;
  const int pstep = step / cv;
  Affine a;
  if constexpr (BN) load_affine(a, scale, shift, cg);
  const long long row = static_cast<long long>(w) * cv;  // vectors of an input row
  for (int p0 = t / cv; p0 < pixels; p0 += POOL_UNROLL * pstep) {
    uint4 win[POOL_UNROLL][4];
#pragma unroll
    for (int i = 0; i < POOL_UNROLL; ++i) {
      const int p = p0 + i * pstep;
      if (p < pixels) {
        const int j = p % wo, q = p / wo;
        const int n = q / ho, y = q % ho;
        const uint4* src = x + ((static_cast<long long>(n) * h + 2 * y) * w + 2 * j) * cv + cg;
        win[i][0] = __ldcs(src);
        win[i][1] = __ldcs(src + cv);
        win[i][2] = __ldcs(src + row);
        win[i][3] = __ldcs(src + row + cv);
      }
    }
#pragma unroll
    for (int i = 0; i < POOL_UNROLL; ++i) {
      const int p = p0 + i * pstep;
      if (p < pixels) {
        uint32_t o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = pool_lane<BN>(win[i], a, k);
        __stcs(out + static_cast<long long>(p) * cv + cg,
               make_uint4(o[0] | o[1] << 16, o[2] | o[3] << 16, o[4] | o[5] << 16,
                          o[6] | o[7] << 16));
      }
    }
  }
}

int sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) cached[dev] = n;
  return n;
}

// Threads in use for work units of cv vectors each: a multiple of cv, at
// most one resident grid of the kernel (rounded up to whole units, so at
// least cv), at most the work. 0 where the device cannot be read. blocks
// caches the kernel's resident blocks a SM (its caller's, one a kernel).
template <typename Kernel>
long long threads_for(Kernel kernel, int& blocks, long long work, int cv) {
  if (!blocks && cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, 0) !=
                     cudaSuccess) {
    blocks = 0;
  }
  const long long resident = static_cast<long long>(sm_count()) * blocks * THREADS;
  if (resident <= 0) return 0;
  const long long want = work < resident ? work : resident;
  return (want + cv - 1) / cv * cv;
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + THREADS - 1) / THREADS);
}

template <int RES>
int launch_bn(const void* x, const float* scale, const float* shift, const void* r,
              const float* scale2, const float* shift2, void* out, long long pixels, int c,
              void* stream) {
  if (pixels < 0 || c < 8 || c % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int cv = c / 8;
  const long long vecs = pixels * cv;
  if (vecs > 0) {
    static int blocks = 0;
    const long long step = threads_for(rn_bn_kernel<RES>, blocks, vecs, cv);
    if (step <= 0) return static_cast<int>(cudaErrorInvalidValue);
    rn_bn_kernel<RES><<<blocks_for(step), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), scale, shift, static_cast<const uint4*>(r), scale2,
        shift2, static_cast<uint4*>(out), vecs, cv, step);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool BN>
int launch_pool(const void* x, const float* scale, const float* shift, void* out, int n, int h,
                int w, int c, void* stream) {
  if (n < 0 || h < 0 || w < 0 || c < 8 || c % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int cv = c / 8, ho = h / 2, wo = w / 2;
  const long long pixels = static_cast<long long>(n) * ho * wo;
  if (pixels * cv > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (pixels > 0) {
    static int blocks = 0;
    const long long step = threads_for(rn_pool_kernel<BN>, blocks, pixels * cv, cv);
    if (step <= 0) return static_cast<int>(cudaErrorInvalidValue);
    rn_pool_kernel<BN><<<blocks_for(step), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), scale, shift, static_cast<uint4*>(out), h, w, ho, wo, cv,
        static_cast<int>(pixels), static_cast<int>(step));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evs_rn_bn_relu(const void* x, const float* scale, const float* shift, void* out,
                              long long pixels, int c, void* stream) {
  return launch_bn<NO_RESIDUAL>(x, scale, shift, nullptr, nullptr, nullptr, out, pixels, c,
                                stream);
}

extern "C" int evs_rn_bn_add_relu(const void* x, const float* scale, const float* shift,
                                  const void* r, void* out, long long pixels, int c,
                                  void* stream) {
  return launch_bn<RESIDUAL>(x, scale, shift, r, nullptr, nullptr, out, pixels, c, stream);
}

extern "C" int evs_rn_bn_bn_add_relu(const void* x, const float* scale, const float* shift,
                                     const void* y, const float* scale2, const float* shift2,
                                     void* out, long long pixels, int c, void* stream) {
  return launch_bn<NORMED>(x, scale, shift, y, scale2, shift2, out, pixels, c, stream);
}

extern "C" int evs_rn_bn_relu_pool(const void* x, const float* scale, const float* shift,
                                   void* out, int n, int h, int w, int c, void* stream) {
  return launch_pool<true>(x, scale, shift, out, n, h, w, c, stream);
}

extern "C" int evs_rn_avg_pool(const void* x, void* out, int n, int h, int w, int c,
                               void* stream) {
  return launch_pool<false>(x, nullptr, nullptr, out, n, h, w, c, stream);
}
