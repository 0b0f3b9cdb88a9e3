// Fused epipolar attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` / `_pallas_attention` in
// epipolar_transformers_tpu/ops/epipolar_attention_pallas.py together with
// the two XLA matmuls around it (G = f1 f2k^T before, out = n f2v after).
//
// What it computes, per query pixel q of item b and sample k of its
// epipolar line (K samples, bilinear corners c with weights w_c):
//
//   sim[q,k] = sum_c w_c <f1[q], f2k[corner_c]>          (0 when all w_c = 0)
//   masked   = sim == 0 ? -1e10 : sim
//   w[q,k]   = softmax_k(scale * (masked [+ prior])) [* prior]
//              | masked [+ prior] / K                  (softmax off)
//              | prior                                 (similarity 'prior')
//   depth[b,k,q] = w[q,k]
//   out[q]   = sum_k w[q,k] sum_c w_c f2v[corner_c]
//
// The TPU kernel split off the Gram matrix G (HW x HW) and the weight matrix
// n (HW x HW) only because Mosaic cannot reshape in-kernel, contracts one
// dimension and has 16 MB of VMEM.  By linearity neither is needed here:
// the similarity is a weighted sum of four corner dot products and the
// output a weighted sum of four corner rows, so G and n (32 MiB each per
// item in bf16) never exist.
//
// What bounds it (reckoned from the shapes, not measured): per item the
// source features are HW x C = 4096 x 256, 2 MiB in bf16 (4 MiB in f32),
// which for a batch of 8 fits in the 50 MB L2.  Each query reads 4 x K = 256
// corner rows for the keys and as many for the values: ~256 KiB per query
// in bf16, ~8 GiB of L2/L1 traffic per batch of 8 x 4096 queries.  So the
// kernel is bound by gather bandwidth, not FLOPs (the Gram form it replaces
// does ~137 GFLOP of matmul per batch).  The design keeps every gathered row
// a 16-byte-per-lane coalesced load and everything else in registers.
// Query tiling that reuses corner rows across neighbouring queries, TMA and
// wgmma are later work.
//
// Shape of the kernel: one warp per query pixel.  Lane l holds channels
// [l*NV, l*NV + NV) of the C = 32*NV channels.  Lane l also owns samples
// k = l + 32*i and computes their slot data with exactly the rules of
// quad_gather._axis_slot_weights; the warp walks the samples, broadcasting
// each sample's slot data with shuffles, and reduces each dot product with
// a butterfly.  The masked softmax over K runs inside the warp (each lane
// holds K/32 values).  A second sweep accumulates `out` in f32 registers.
//
// Plain C entry point (loaded with ctypes); returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e10f;  // reference epipolar.py:298
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxSlotsPerLane = 4;  // K <= 128
constexpr unsigned kFull = 0xffffffffu;

// quad_gather._axis_slot_weights: base in [0, size-1]; w0/w1 the weights of
// the slot-0/slot-1 corners, zero for a corner outside [0, size-1].
__device__ __forceinline__ void axis_slot_weights(float coord, int size,
                                                  int& base, float& w0,
                                                  float& w1) {
  const float c0 = floorf(coord);
  const float frac = coord - c0;
  const float hi = (float)(size - 1);
  base = (int)fminf(fmaxf(c0, 0.f), hi);
  const bool shifted = c0 < 0.f;
  const bool valid0 = (c0 >= 0.f) && (c0 <= hi);
  const bool valid1 = (c0 + 1.f >= 0.f) && (c0 + 1.f <= hi);
  w0 = shifted ? (valid1 ? frac : 0.f) : (valid0 ? 1.f - frac : 0.f);
  w1 = shifted ? 0.f : (valid1 ? frac : 0.f);
}

template <int NV>
__device__ __forceinline__ void load_row(const float* p, float (&v)[NV]) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NV; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (NV == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int NV>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[NV]) {
  if constexpr (NV % 8 == 0) {
#pragma unroll
    for (int i = 0; i < NV; i += 8) {
      const uint4 t = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[i + 2 * j] = f.x; v[i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (NV == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else if constexpr (NV == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <typename T, int NV>
__device__ __forceinline__ float dot_row(const T* p, const float (&q)[NV]) {
  float r[NV];
  load_row<NV>(p, r);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) acc = fmaf(q[i], r[i], acc);
  return acc;
}

template <typename T, int NV>
__device__ __forceinline__ void axpy_row(const T* p, float a,
                                         float (&acc)[NV]) {
  float r[NV];
  load_row<NV>(p, r);
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = fmaf(a, r[i], acc[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

struct Params {
  const void* f1;      // (B, HW, C) queries
  const void* f2k;     // (B, HW, C) keys
  const void* f2v;     // (B, HW, C) values
  const float* locs;   // (B, K, HW, 2) normalized (-1, 1) sample locations
  const float* prior;  // (B, K, HW) or null
  float* out;          // (B, HW, C)
  float* depth;        // (B, K, HW)
  int B, H, W, K;
  float scale;
  int use_sim;   // similarity != 'prior'
  int softmax;   // softmax enabled
  int priormul;  // multiply the prior after the softmax
};

// One sample's four corner weights (row-major slot order 00, 01, 10, 11).
struct Corners {
  int base;
  float c00, c01, c10, c11;
};

__device__ __forceinline__ Corners broadcast_corners(int base, float wx0,
                                                     float wx1, float wy0,
                                                     float wy1, int src) {
  Corners c;
  c.base = __shfl_sync(kFull, base, src);
  const float x0 = __shfl_sync(kFull, wx0, src);
  const float x1 = __shfl_sync(kFull, wx1, src);
  const float y0 = __shfl_sync(kFull, wy0, src);
  const float y1 = __shfl_sync(kFull, wy1, src);
  c.c00 = y0 * x0;
  c.c01 = y0 * x1;
  c.c10 = y1 * x0;
  c.c11 = y1 * x1;
  return c;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
epipolar_attention_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int HW = p.H * p.W;
  const long long gq =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gq >= (long long)p.B * HW) return;  // uniform across the warp
  const int b = (int)(gq / HW);
  const int q = (int)(gq - (long long)b * HW);
  const int C = 32 * NV;
  const int K = p.K;
  const int W = p.W;

  // slot data of this lane's samples k = lane + 32 * i
  int base[kMaxSlotsPerLane];
  float wx0[kMaxSlotsPerLane], wx1[kMaxSlotsPerLane];
  float wy0[kMaxSlotsPerLane], wy1[kMaxSlotsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) {
    const int k = lane + 32 * i;
    base[i] = 0;
    wx0[i] = wx1[i] = wy0[i] = wy1[i] = 0.f;
    if (k < K) {
      const float* l = p.locs + (((size_t)b * K + k) * HW + q) * 2;
      // align_corners=True unnormalize, as the JAX wrapper computes it
      const float x = (l[0] + 1.0f) / 2.0f * (float)(W - 1);
      const float y = (l[1] + 1.0f) / 2.0f * (float)(p.H - 1);
      int xb, yb;
      axis_slot_weights(x, W, xb, wx0[i], wx1[i]);
      axis_slot_weights(y, p.H, yb, wy0[i], wy1[i]);
      base[i] = yb * W + xb;
    }
  }

  const size_t item = (size_t)b * HW;
  float w[kMaxSlotsPerLane];
  float pr[kMaxSlotsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) {
    const int k = lane + 32 * i;
    pr[i] = (p.prior != nullptr && k < K)
                ? p.prior[((size_t)b * K + k) * HW + q] : 0.f;
    w[i] = 0.f;
  }

  if (p.use_sim) {
    const T* f1 = static_cast<const T*>(p.f1) + (item + q) * C + lane * NV;
    const T* f2k = static_cast<const T*>(p.f2k) + item * C + lane * NV;
    float qv[NV];
    load_row<NV>(f1, qv);

    float s[kMaxSlotsPerLane];
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      if (32 * i >= K) break;
      for (int j = 0; j < 32 && 32 * i + j < K; ++j) {
        const Corners c =
            broadcast_corners(base[i], wx0[i], wx1[i], wy0[i], wy1[i], j);
        float acc = 0.f;
        // corner weights are warp-uniform, so these branches do not diverge;
        // a zero-weight corner may lie outside the image and is never read
        if (c.c00 != 0.f) acc += c.c00 * dot_row<T, NV>(f2k + (size_t)c.base * C, qv);
        if (c.c01 != 0.f) acc += c.c01 * dot_row<T, NV>(f2k + (size_t)(c.base + 1) * C, qv);
        if (c.c10 != 0.f) acc += c.c10 * dot_row<T, NV>(f2k + (size_t)(c.base + W) * C, qv);
        if (c.c11 != 0.f) acc += c.c11 * dot_row<T, NV>(f2k + (size_t)(c.base + W + 1) * C, qv);
        acc = warp_sum(acc);
        if (lane == j) s[i] = acc;
      }
    }

    // zero-sentinel mask, additive prior, softmax or 1/K, prior multiply
    float logit[kMaxSlotsPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      const bool valid = lane + 32 * i < K;
      float m = (s[i] == 0.f) ? kNegInf : s[i];
      if (p.prior != nullptr && !p.priormul) m = m + pr[i];
      if (p.softmax) {
        logit[i] = valid ? m * p.scale : -INFINITY;
        mx = fmaxf(mx, logit[i]);
      } else {
        w[i] = valid ? m / (float)K : 0.f;
      }
    }
    if (p.softmax) {
      mx = warp_max(mx);
      float e[kMaxSlotsPerLane];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxSlotsPerLane; ++i) {
        e[i] = (lane + 32 * i < K) ? expf(logit[i] - mx) : 0.f;
        sum += e[i];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int i = 0; i < kMaxSlotsPerLane; ++i) {
        w[i] = e[i] / sum;
        if (p.prior != nullptr && p.priormul) w[i] = w[i] * pr[i];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) w[i] = pr[i];
  }

#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) {
    const int k = lane + 32 * i;
    if (k < K) p.depth[((size_t)b * K + k) * HW + q] = w[i];
  }

  // second sweep: out[q] = sum_k w_k sum_c w_c f2v[corner_c]
  const T* f2v = static_cast<const T*>(p.f2v) + item * C + lane * NV;
  float acc[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) acc[t] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) {
    if (32 * i >= K) break;
    for (int j = 0; j < 32 && 32 * i + j < K; ++j) {
      const float wk = __shfl_sync(kFull, w[i], j);
      const Corners c =
          broadcast_corners(base[i], wx0[i], wx1[i], wy0[i], wy1[i], j);
      if (wk == 0.f) continue;  // warp-uniform
      if (c.c00 != 0.f) axpy_row<T, NV>(f2v + (size_t)c.base * C, wk * c.c00, acc);
      if (c.c01 != 0.f) axpy_row<T, NV>(f2v + (size_t)(c.base + 1) * C, wk * c.c01, acc);
      if (c.c10 != 0.f) axpy_row<T, NV>(f2v + (size_t)(c.base + W) * C, wk * c.c10, acc);
      if (c.c11 != 0.f) axpy_row<T, NV>(f2v + (size_t)(c.base + W + 1) * C, wk * c.c11, acc);
    }
  }
  float* o = p.out + (item + q) * C + lane * NV;
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int t = 0; t < NV; t += 4)
      *reinterpret_cast<float4*>(o + t) =
          make_float4(acc[t], acc[t + 1], acc[t + 2], acc[t + 3]);
  } else {
#pragma unroll
    for (int t = 0; t < NV; ++t) o[t] = acc[t];
  }
}

template <typename T>
cudaError_t launch(const Params& p, int C, cudaStream_t stream) {
  const long long queries = (long long)p.B * p.H * p.W;
  const dim3 grid((unsigned)((queries + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  switch (C) {
    case 32: epipolar_attention_kernel<T, 1><<<grid, block, 0, stream>>>(p); break;
    case 64: epipolar_attention_kernel<T, 2><<<grid, block, 0, stream>>>(p); break;
    case 128: epipolar_attention_kernel<T, 4><<<grid, block, 0, stream>>>(p); break;
    case 256: epipolar_attention_kernel<T, 8><<<grid, block, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int epipolar_attention_forward(
    const void* f1, const void* f2k, const void* f2v, const void* locs,
    const void* prior, void* out, void* depth, int B, int H, int W, int K,
    int C, int is_bf16, float scale, int use_sim, int softmax, int priormul,
    void* stream) {
  if (B < 1 || H < 1 || W < 1 || K < 1 || K > 32 * kMaxSlotsPerLane)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.f1 = f1;
  p.f2k = f2k;
  p.f2v = f2v;
  p.locs = static_cast<const float*>(locs);
  p.prior = static_cast<const float*>(prior);
  p.out = static_cast<float*>(out);
  p.depth = static_cast<float*>(depth);
  p.B = B;
  p.H = H;
  p.W = W;
  p.K = K;
  p.scale = scale;
  p.use_sim = use_sim;
  p.softmax = softmax;
  p.priormul = priormul;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(p, C, s)
                                  : launch<float>(p, C, s);
  return (int)err;
}

extern "C" int epipolar_attention_max_samples() { return 32 * kMaxSlotsPerLane; }
