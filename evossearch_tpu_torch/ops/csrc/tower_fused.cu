// The CLIP towers' elementwise chains, one pass each.
//
// Replaces no Pallas kernel: the JAX package leaves these chains to XLA,
// which fuses elementwise chains itself. The port's
// plain versions (ops/tower.py:*_plain, called from models/layers.py) run
// them as 3-13 separate PyTorch passes over float32 tensors. Four entry
// points, each reading its input once and writing its output once, with
// every intermediate in registers:
//
//   evs_bias_cast       bf16(y + b): a dense layer's float32 GEMM output
//                       (M, N) and float32 bias (N) -> bf16 (M, N).
//   evs_bias_gelu_cast  quick-GELU of the same value, rounded to bf16 at
//                       each step as the plain path rounds it:
//                       h = bf16(y + b), t = bf16(1.702 h),
//                       s = bf16(1 / (1 + exp(-t))), out = bf16(h s).
//   evs_layer_norm      a bf16 row (width w) -> float32 two-pass mean and
//                       variance -> (x - mean) * rsqrt(var + eps) * scale
//                       + bias -> bf16.
//   evs_softmax_cast    float32 attention logits rows of length t ->
//                       l * scale, the causal mask (-FLT_MAX above the
//                       diagonal), max, exp(x - max), sum, divide -> bf16.
//
// Numerics: the plain path's float32 arithmetic, operation for operation:
// the same roundings (explicit __fadd_rn/__fmul_rn, so nvcc contracts no
// multiply-add into an FMA that the plain path does not have), precise
// expf and IEEE division (no fast math), rsqrtf as torch.rsqrt calls it,
// round-to-nearest-even casts, and the plain path's summation orders:
//   * the softmax's, torch's warp softmax (softmax_warp_forward): lane l
//     holds elements l + 32 i and sums them in i order, then a butterfly
//     over the warp with offsets 16, 8, 4, 2, 1;
//   * the LayerNorm's mean and variance, torch's vectorised inner reduction
//     (Reduce.cuh, taken for rows of more than 128 floats): one warp per
//     row, lane l adds the 4-value vectors l + 32 k, k in order, into four
//     accumulators, combines them ((a0 + a1) + a2) + a3, then the same
//     butterfly over the lanes, times torch's factor fl(rows / (rows * w)),
//     which the caller passes (this order matched torch 2.11's mean on an
//     H100 on every row of 131,584 at widths 512, 768 and 1,024).
// So each kernel gives the plain path's bits: on an H100 under torch 2.11
// all four did at ViT-L/14's batch-512 shapes (chip_smoke.py). The tests
// hold the bias kernels to that, and the LayerNorm and the softmax, whose
// orders are torch's choice, to one bf16 ulp.
//
// What bounds them on an H100: bytes, at 3.35 TB/s. Each reads its input
// once (float32 logits and GEMM outputs, bf16 LayerNorm rows) and writes
// bf16 once; the parameters (bias, scale) are a few KB read from L1/L2.
// Their times beside that bound: PERF.md (chip_smoke.py, phase
// tower_fused).
//
// Design:
//   * bias kernels: a block of 128 threads owns 1,024 columns (8 a thread,
//     two 16-byte float4 loads and one 16-byte store per row) and 16 rows;
//     each thread reads its 8 bias values once and walks its rows 4 at a
//     time (2 with the GELU, which needs more registers), all their loads
//     in flight before any arithmetic. N % 8 == 0.
//   * LayerNorm: one warp per row, 8-byte vectors of 4 bf16, vector v
//     held by lane v % 32 in registers (KV vectors a lane, w <= 128 KV),
//     two warp reductions (mean, then the squared deviations, recomputed
//     from the registers). w % 4 == 0, w <= 2048.
//   * softmax: one warp per row, element j held by lane j % 32 (IT
//     elements a lane, t <= 32 IT), coalesced 4-byte loads (rows of odd
//     length are not 16-byte aligned). t <= 1024.
// Every launch is on the caller's stream; each entry point returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take, before launching anything).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BIAS_THREADS = 128;  // threads of a bias block, 8 columns each
constexpr int BIAS_ROWS = 16;      // rows of a bias block
constexpr int ROW_THREADS = 256;   // LayerNorm and softmax: 8 warps, a row each
constexpr int ROWS_PER_BLOCK = ROW_THREADS / 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The value written for GEMM output y and bias b.
template <bool GELU>
__device__ __forceinline__ __nv_bfloat16 bias_epilogue(float y, float b) {
  const __nv_bfloat16 h = __float2bfloat16_rn(__fadd_rn(y, b));
  if constexpr (!GELU) return h;
  // quick_gelu on a bf16 tensor: each op computes in float32 and rounds
  // to bf16 (torch's opmath); the scalar is the double 1.702 cast to float
  const float hf = __bfloat162float(h);
  const float t = bf16_round(__fmul_rn(static_cast<float>(1.702), hf));
  const float s = bf16_round(1.0f / (1.0f + expf(-t)));  // torch's sigmoid
  return __float2bfloat16_rn(__fmul_rn(hf, s));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The sum over the warp, every lane the same, in the order of torch's warp
// reductions (softmax_warp_forward's warp_reduce and Reduce.cuh's
// block_x_reduce): offsets 16, 8, 4, 2, 1, lane l adding lane l + offset's
// value (the butterfly gives every lane lane 0's sum, since a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, offset);
    v = v < o ? o : v;
  }
  return v;
}

// grid: (ceil(m / BIAS_ROWS), ceil(n / 8 / BIAS_THREADS))
template <bool GELU>
__global__ void __launch_bounds__(BIAS_THREADS)
    bias_kernel(const float* __restrict__ y, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, long long m, int n) {
  const int c = blockIdx.y * BIAS_THREADS + threadIdx.x;  // 8-column chunk
  if (c >= n / 8) return;
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias) + 2 * c);
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias) + 2 * c + 1);
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const long long r0 = static_cast<long long>(blockIdx.x) * BIAS_ROWS;
  const long long r1 = r0 + BIAS_ROWS < m ? r0 + BIAS_ROWS : m;
  constexpr int STEP = GELU ? 2 : 4;  // rows whose loads are in flight at once
  for (long long r = r0; r < r1; r += STEP) {
    float4 v[STEP][2];
#pragma unroll
    for (int i = 0; i < STEP; ++i) {
      if (r + i < r1) {
        const float4* src = reinterpret_cast<const float4*>(y + (r + i) * n) + 2 * c;
        v[i][0] = src[0];
        v[i][1] = src[1];
      }
    }
#pragma unroll
    for (int i = 0; i < STEP; ++i) {
      if (r + i < r1) {
        const float x[8] = {v[i][0].x, v[i][0].y, v[i][0].z, v[i][0].w,
                            v[i][1].x, v[i][1].y, v[i][1].z, v[i][1].w};
        uint4 o;
        o.x = pack2(bias_epilogue<GELU>(x[0], b[0]), bias_epilogue<GELU>(x[1], b[1]));
        o.y = pack2(bias_epilogue<GELU>(x[2], b[2]), bias_epilogue<GELU>(x[3], b[3]));
        o.z = pack2(bias_epilogue<GELU>(x[4], b[4]), bias_epilogue<GELU>(x[5], b[5]));
        o.w = pack2(bias_epilogue<GELU>(x[6], b[6]), bias_epilogue<GELU>(x[7], b[7]));
        *reinterpret_cast<uint4*>(out + (r + i) * n + 8 * c) = o;
      }
    }
  }
}

// The row's sum in torch's order (see the note at the top) of the values
// f(v[k][i]) of the vectors this lane holds (vector lane + 32 k of vecs).
template <int KV, typename F>
__device__ __forceinline__ float torch_row_sum(const float (&v)[KV][4], int lane, int vecs, F f) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    if (lane + 32 * k < vecs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], f(v[k][i]));
    }
  }
  return warp_sum(__fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]));
}

// One warp per row; KV 8-byte vectors (4 values) per lane.
template <int KV>
__global__ void __launch_bounds__(ROW_THREADS)
    layer_norm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                      long long rows, int w, float factor, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int vecs = w / 4;
  const uint2* src = reinterpret_cast<const uint2*>(x + row * w);
  float v[KV][4];
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int c = lane + 32 * k;
    const uint2 u = c < vecs ? src[c] : make_uint2(0u, 0u);
    v[k][0] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.x & 0xffffu)));
    v[k][1] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.x >> 16)));
    v[k][2] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.y & 0xffffu)));
    v[k][3] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.y >> 16)));
  }
  // x.mean(-1), then (x - mean).square().mean(-1): each torch's sum times factor
  const float mean = __fmul_rn(torch_row_sum(v, lane, vecs, [](float a) { return a; }), factor);
  const float var = __fmul_rn(torch_row_sum(v, lane, vecs, [mean](float a) {
                                const float d = __fsub_rn(a, mean);
                                return __fmul_rn(d, d);
                              }),
                              factor);
  const float r = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int c = lane + 32 * k;
    if (c < vecs) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale) + c);
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias) + c);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
      __nv_bfloat16 o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float yv = __fmul_rn(__fsub_rn(v[k][i], mean), r);
        o[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(yv, s[i]), b[i]));
      }
      reinterpret_cast<uint2*>(out + row * w)[c] = make_uint2(pack2(o[0], o[1]), pack2(o[2], o[3]));
    }
  }
}

// One warp per row of t logits; IT elements per lane (element j at lane
// j % 32, slot j / 32), as torch's softmax_warp_forward holds them.
template <int IT>
__global__ void __launch_bounds__(ROW_THREADS)
    softmax_kernel(const float* __restrict__ logits, __nv_bfloat16* __restrict__ out,
                   long long rows, int t, float scale, int causal) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* src = logits + row * t;
  const int query = static_cast<int>(row % t);  // rows are (..., query, key)
  float v[IT];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int j = lane + 32 * i;
    if (j < t) {
      const float l = __fmul_rn(src[j], scale);
      v[i] = causal && j > query ? -FLT_MAX : l;
    } else {
      v[i] = __int_as_float(0xff800000);  // -inf: no element
    }
  }
  float mx = v[0];
#pragma unroll
  for (int i = 1; i < IT; ++i) mx = mx > v[i] ? mx : v[i];
  mx = warp_max(mx);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    if (lane + 32 * i < t) {
      v[i] = expf(__fsub_rn(v[i], mx));
      sum = __fadd_rn(sum, v[i]);
    }
  }
  sum = warp_sum(sum);
  __nv_bfloat16* dst = out + row * t;
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int j = lane + 32 * i;
    if (j < t) dst[j] = __float2bfloat16_rn(v[i] / sum);
  }
}

template <bool GELU>
int launch_bias(const float* y, const float* bias, void* out, long long m, int n,
                cudaStream_t st) {
  if (m < 0 || n < 8 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_blocks = (m + BIAS_ROWS - 1) / BIAS_ROWS;
  const int col_blocks = (n / 8 + BIAS_THREADS - 1) / BIAS_THREADS;
  if (row_blocks > 0x7fffffffLL || col_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m > 0) {
    const dim3 grid(static_cast<unsigned>(row_blocks), static_cast<unsigned>(col_blocks));
    bias_kernel<GELU><<<grid, BIAS_THREADS, 0, st>>>(y, bias, static_cast<__nv_bfloat16*>(out),
                                                      m, n);
  }
  return static_cast<int>(cudaGetLastError());
}

unsigned row_grid(long long rows) {
  return static_cast<unsigned>((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
}

}  // namespace

extern "C" int evs_bias_cast(const float* y, const float* bias, void* out, long long m, int n,
                             void* stream) {
  return launch_bias<false>(y, bias, out, m, n, static_cast<cudaStream_t>(stream));
}

extern "C" int evs_bias_gelu_cast(const float* y, const float* bias, void* out, long long m,
                                  int n, void* stream) {
  return launch_bias<true>(y, bias, out, m, n, static_cast<cudaStream_t>(stream));
}

extern "C" int evs_layer_norm(const void* x, const float* scale, const float* bias, void* out,
                              long long rows, int w, float factor, float eps, void* stream) {
  if (rows < 0 || w < 4 || w % 4 || w > 2048 ||
      (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xin = static_cast<const __nv_bfloat16*>(x);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (rows > 0) {
    const int kv = (w / 4 + 31) / 32;  // vectors per lane
    const unsigned grid = row_grid(rows);
    if (kv <= 1) {
      layer_norm_kernel<1><<<grid, ROW_THREADS, 0, st>>>(xin, scale, bias, o, rows, w, factor, eps);
    } else if (kv <= 2) {
      layer_norm_kernel<2><<<grid, ROW_THREADS, 0, st>>>(xin, scale, bias, o, rows, w, factor, eps);
    } else if (kv <= 4) {
      layer_norm_kernel<4><<<grid, ROW_THREADS, 0, st>>>(xin, scale, bias, o, rows, w, factor, eps);
    } else if (kv <= 8) {
      layer_norm_kernel<8><<<grid, ROW_THREADS, 0, st>>>(xin, scale, bias, o, rows, w, factor, eps);
    } else {
      layer_norm_kernel<16><<<grid, ROW_THREADS, 0, st>>>(xin, scale, bias, o, rows, w, factor, eps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int evs_softmax_cast(const float* logits, void* out, long long rows, int t,
                                float scale, int causal, void* stream) {
  if (rows < 0 || t < 1 || t > 1024 || (rows > 0 && rows % t) ||
      (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (rows > 0) {
    const int it = (t + 31) / 32;  // elements per lane
    const unsigned grid = row_grid(rows);
    if (it <= 1) {
      softmax_kernel<1><<<grid, ROW_THREADS, 0, st>>>(logits, o, rows, t, scale, causal);
    } else if (it <= 2) {
      softmax_kernel<2><<<grid, ROW_THREADS, 0, st>>>(logits, o, rows, t, scale, causal);
    } else if (it <= 4) {
      softmax_kernel<4><<<grid, ROW_THREADS, 0, st>>>(logits, o, rows, t, scale, causal);
    } else if (it <= 8) {
      softmax_kernel<8><<<grid, ROW_THREADS, 0, st>>>(logits, o, rows, t, scale, causal);
    } else if (it <= 16) {
      softmax_kernel<16><<<grid, ROW_THREADS, 0, st>>>(logits, o, rows, t, scale, causal);
    } else {
      softmax_kernel<32><<<grid, ROW_THREADS, 0, st>>>(logits, o, rows, t, scale, causal);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
