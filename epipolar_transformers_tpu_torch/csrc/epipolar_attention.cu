// Fused epipolar attention, forward and backward, for Hopper (sm_90a).
//
// The forward replaces the TPU kernel `_make_kernel` / `_pallas_attention` in
// epipolar_transformers_tpu/ops/epipolar_attention_pallas.py together with
// the two XLA matmuls around it (G = f1 f2k^T before, out = n f2v after).
// The TPU package has no backward kernel: it trains by jax.grad of the XLA
// matmul path (epipolar_transformers_tpu/ops/epipolar_attention_matmul.py),
// and the backward here is held to that.
//
// What the forward computes, per query pixel q of item b and sample k of its
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
// The backward, with p the softmax, g = dL/dw and dout = dL/dout[q]:
//
//   g[k]      = sum_c w_c <dout[q], f2v[corner_c]>
//   ds[k]     = scale p_k (g'_k - sum_j p_j g'_j)   g' = g * prior under
//                                                  priormul, else g
//             | g_k / K                            (softmax off)
//             | 0 where sim == 0 exactly (the masked -1e10 is a constant),
//               and for similarity 'prior'
//   dfeat1[q]  = sum_k ds[k] sum_c w_c f2k[corner_c]
//   dother1[corner_c] += ds[k] w_c f1[q]
//   dother2[corner_c] += w[k]  w_c dout[q]
//
// It recomputes the slot data and the similarities with the forward's rules
// instead of reading the forward's weights: the zero-sentinel mask and,
// under priormul with a zero prior, p itself cannot be recovered from w.
//
// What bounds them (reckoned from the shapes, not measured): per item the
// source features are HW x C = 4096 x 256, 2 MiB in bf16 (4 MiB in f32),
// which for a batch of 8 fits in the 50 MB L2.  Each query reads 4 x K = 256
// corner rows for the keys and as many for the values: ~256 KiB per query
// in bf16, ~8 GiB of L2/L1 traffic per batch of 8 x 4096 queries.  So the
// forward is bound by gather bandwidth, not FLOPs (the Gram form it replaces
// does ~137 GFLOP of matmul per batch).  The backward gathers the key rows
// twice and the value rows once, and scatters into the key and value
// gradients with f32 atomics: 8 x 4096 x 256 x 256 ~ 2.1 G adds each, issued
// as 16-byte vector atomics (sm_90) where a lane holds 4 or more channels.
// Those atomics, contended where neighbouring queries share corner rows, are
// its likely bound.  The design keeps every gathered row a coalesced load and
// everything else in registers.  Query tiling that reuses corner rows across
// neighbouring queries (and turns the scatter into per-tile shared-memory
// reductions), TMA and wgmma are later work.
//
// Shape of both kernels: one warp per query pixel.  Lane l holds channels
// [l*NV, l*NV + NV) of the C = 32*NV channels.  Lane l also owns samples
// k = l + 32*i and computes their slot data with exactly the rules of
// quad_gather._axis_slot_weights; the warp walks the samples, broadcasting
// each sample's slot data with shuffles, and reduces each dot product with
// a butterfly.  The masked softmax over K runs inside the warp (each lane
// holds K/32 values).  A second sweep accumulates `out` (forward) or
// `dfeat1` and the scatters (backward) in f32 registers.
//
// Plain C entry points (loaded with ctypes); each returns cudaGetLastError().

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

template <int NV>
__device__ __forceinline__ void store_row(float* p, const float (&v)[NV]) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int t = 0; t < NV; t += 4)
      *reinterpret_cast<float4*>(p + t) =
          make_float4(v[t], v[t + 1], v[t + 2], v[t + 3]);
  } else {
#pragma unroll
    for (int t = 0; t < NV; ++t) p[t] = v[t];
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

// dst[0:NV] += a * v, with sm_90's 16- and 8-byte vector atomics where the
// lane's slice allows them (global memory, aligned by the row layout)
template <int NV>
__device__ __forceinline__ void atomic_axpy_row(float* dst, float a,
                                                const float (&v)[NV]) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int t = 0; t < NV; t += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + t),
                make_float4(a * v[t], a * v[t + 1], a * v[t + 2], a * v[t + 3]));
    return;
  } else if constexpr (NV == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a * v[0], a * v[1]));
    return;
  }
#endif
#pragma unroll
  for (int t = 0; t < NV; ++t) atomicAdd(dst + t, a * v[t]);
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
  float* out;          // forward: (B, HW, C)
  float* depth;        // forward: (B, K, HW)
  const float* dout;   // backward: (B, HW, C) gradient of out
  float* dfeat1;       // backward: (B, HW, C)
  float* dother1;      // backward: (B, HW, C), zeroed by the caller, or null
  float* dother2;      // backward: (B, HW, C), zeroed by the caller, or null
  int B, H, W, K;
  float scale;
  int use_sim;   // similarity != 'prior'
  int softmax;   // softmax enabled
  int priormul;  // multiply the prior after the softmax
};

// Slot data of one lane's samples k = lane + 32 * i, and their priors.
struct Slots {
  int base[kMaxSlotsPerLane];
  float wx0[kMaxSlotsPerLane], wx1[kMaxSlotsPerLane];
  float wy0[kMaxSlotsPerLane], wy1[kMaxSlotsPerLane];
  float pr[kMaxSlotsPerLane];
};

__device__ __forceinline__ void load_slots(const Params& p, int b, int q,
                                           int lane, Slots& s) {
  const int HW = p.H * p.W;
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) {
    const int k = lane + 32 * i;
    s.base[i] = 0;
    s.wx0[i] = s.wx1[i] = s.wy0[i] = s.wy1[i] = 0.f;
    s.pr[i] = 0.f;
    if (k < p.K) {
      const float* l = p.locs + (((size_t)b * p.K + k) * HW + q) * 2;
      // align_corners=True unnormalize, as the JAX wrapper computes it
      const float x = (l[0] + 1.0f) / 2.0f * (float)(p.W - 1);
      const float y = (l[1] + 1.0f) / 2.0f * (float)(p.H - 1);
      int xb, yb;
      axis_slot_weights(x, p.W, xb, s.wx0[i], s.wx1[i]);
      axis_slot_weights(y, p.H, yb, s.wy0[i], s.wy1[i]);
      s.base[i] = yb * p.W + xb;
      if (p.prior != nullptr) s.pr[i] = p.prior[((size_t)b * p.K + k) * HW + q];
    }
  }
}

// One sample's four corner weights (row-major slot order 00, 01, 10, 11).
struct Corners {
  int base;
  float c00, c01, c10, c11;
};

__device__ __forceinline__ Corners broadcast_corners(const Slots& s, int i,
                                                     int src) {
  Corners c;
  c.base = __shfl_sync(kFull, s.base[i], src);
  const float x0 = __shfl_sync(kFull, s.wx0[i], src);
  const float x1 = __shfl_sync(kFull, s.wx1[i], src);
  const float y0 = __shfl_sync(kFull, s.wy0[i], src);
  const float y1 = __shfl_sync(kFull, s.wy1[i], src);
  c.c00 = y0 * x0;
  c.c01 = y0 * x1;
  c.c10 = y1 * x0;
  c.c11 = y1 * x1;
  return c;
}

// sum_c w_c <q, rows[corner_c]>, reduced over the warp.  Corner weights are
// warp-uniform, so the branches do not diverge; a zero-weight corner may lie
// outside the image and is never read.
template <typename T, int NV>
__device__ __forceinline__ float corner_dot(const T* rows, const Corners& c,
                                            int W, const float (&q)[NV]) {
  const int C = 32 * NV;
  float acc = 0.f;
  if (c.c00 != 0.f) acc += c.c00 * dot_row<T, NV>(rows + (size_t)c.base * C, q);
  if (c.c01 != 0.f) acc += c.c01 * dot_row<T, NV>(rows + (size_t)(c.base + 1) * C, q);
  if (c.c10 != 0.f) acc += c.c10 * dot_row<T, NV>(rows + (size_t)(c.base + W) * C, q);
  if (c.c11 != 0.f) acc += c.c11 * dot_row<T, NV>(rows + (size_t)(c.base + W + 1) * C, q);
  return warp_sum(acc);
}

// Zero-sentinel mask, additive prior, softmax or 1/K, prior multiply: the
// similarities s of this lane's samples -> their weights w, and (softmax
// on) the softmax p before the prior multiply.
__device__ __forceinline__ void attention_weights(
    const Params& p, const Slots& sl, int lane, const float (&s)[kMaxSlotsPerLane],
    float (&prob)[kMaxSlotsPerLane], float (&w)[kMaxSlotsPerLane]) {
  float logit[kMaxSlotsPerLane];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) {
    const bool valid = lane + 32 * i < p.K;
    float m = (s[i] == 0.f) ? kNegInf : s[i];
    if (p.prior != nullptr && !p.priormul) m = m + sl.pr[i];
    if (p.softmax) {
      logit[i] = valid ? m * p.scale : -INFINITY;
      mx = fmaxf(mx, logit[i]);
    } else {
      w[i] = valid ? m / (float)p.K : 0.f;
      prob[i] = w[i];
    }
  }
  if (p.softmax) {
    mx = warp_max(mx);
    float e[kMaxSlotsPerLane];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      e[i] = (lane + 32 * i < p.K) ? expf(logit[i] - mx) : 0.f;
      sum += e[i];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      prob[i] = e[i] / sum;
      w[i] = prob[i];
      if (p.prior != nullptr && p.priormul) w[i] = w[i] * sl.pr[i];
    }
  }
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

  Slots sl;
  load_slots(p, b, q, lane, sl);

  const size_t item = (size_t)b * HW;
  float w[kMaxSlotsPerLane];
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
        const float acc = corner_dot<T, NV>(f2k, broadcast_corners(sl, i, j), W, qv);
        if (lane == j) s[i] = acc;
      }
    }
    float prob[kMaxSlotsPerLane];
    attention_weights(p, sl, lane, s, prob, w);
  } else {
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) w[i] = sl.pr[i];
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
      const Corners c = broadcast_corners(sl, i, j);
      if (wk == 0.f) continue;  // warp-uniform
      if (c.c00 != 0.f) axpy_row<T, NV>(f2v + (size_t)c.base * C, wk * c.c00, acc);
      if (c.c01 != 0.f) axpy_row<T, NV>(f2v + (size_t)(c.base + 1) * C, wk * c.c01, acc);
      if (c.c10 != 0.f) axpy_row<T, NV>(f2v + (size_t)(c.base + W) * C, wk * c.c10, acc);
      if (c.c11 != 0.f) axpy_row<T, NV>(f2v + (size_t)(c.base + W + 1) * C, wk * c.c11, acc);
    }
  }
  store_row<NV>(p.out + (item + q) * C + lane * NV, acc);
}

template <typename T, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
epipolar_attention_backward_kernel(const Params p) {
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

  Slots sl;
  load_slots(p, b, q, lane, sl);

  const size_t item = (size_t)b * HW;
  const size_t row = (item + q) * C + lane * NV;
  const T* f2k = static_cast<const T*>(p.f2k) + item * C + lane * NV;
  const T* f2v = static_cast<const T*>(p.f2v) + item * C + lane * NV;
  float dv[NV];
  load_row<NV>(p.dout + row, dv);
  float qv[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) qv[t] = 0.f;
  if (p.use_sim) load_row<NV>(static_cast<const T*>(p.f1) + row, qv);

  // first sweep: the similarities (as the forward computes them) and g
  float s[kMaxSlotsPerLane], g[kMaxSlotsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) s[i] = g[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) {
    if (32 * i >= K) break;
    for (int j = 0; j < 32 && 32 * i + j < K; ++j) {
      const Corners c = broadcast_corners(sl, i, j);
      const float sv = p.use_sim ? corner_dot<T, NV>(f2k, c, W, qv) : 0.f;
      const float gv = corner_dot<T, NV>(f2v, c, W, dv);
      if (lane == j) { s[i] = sv; g[i] = gv; }
    }
  }

  // the weights and the logit gradient ds
  float w[kMaxSlotsPerLane], ds[kMaxSlotsPerLane];
  if (p.use_sim) {
    float prob[kMaxSlotsPerLane];
    attention_weights(p, sl, lane, s, prob, w);
    // g' rounded once (no fma contraction), so that a one-hot softmax
    // gives g' - sum_j p_j g'_j == 0 exactly
    const bool mul = p.prior != nullptr && p.priormul;
    float gp[kMaxSlotsPerLane];
    float pg = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      gp[i] = mul ? __fmul_rn(g[i], sl.pr[i]) : g[i];
      if (lane + 32 * i < K) pg += prob[i] * gp[i];
    }
    if (p.softmax) pg = warp_sum(pg);
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      const bool live = lane + 32 * i < K && s[i] != 0.f;
      ds[i] = !live ? 0.f
                    : p.softmax ? p.scale * prob[i] * (gp[i] - pg) : g[i] / (float)K;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      w[i] = sl.pr[i];
      ds[i] = 0.f;
    }
  }

  // second sweep: dfeat1 in registers, the key/value scatters with atomics
  float* d1 = p.dother1 == nullptr ? nullptr : p.dother1 + item * C + lane * NV;
  float* d2 = p.dother2 == nullptr ? nullptr : p.dother2 + item * C + lane * NV;
  float acc[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) acc[t] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) {
    if (32 * i >= K) break;
    for (int j = 0; j < 32 && 32 * i + j < K; ++j) {
      const float dsk = __shfl_sync(kFull, ds[i], j);
      const float wk = __shfl_sync(kFull, w[i], j);
      const Corners c = broadcast_corners(sl, i, j);
      const size_t off[4] = {(size_t)c.base * C, (size_t)(c.base + 1) * C,
                             (size_t)(c.base + W) * C, (size_t)(c.base + W + 1) * C};
      const float wc[4] = {c.c00, c.c01, c.c10, c.c11};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (wc[t] == 0.f) continue;  // warp-uniform, as are dsk and wk
        if (dsk != 0.f) {
          axpy_row<T, NV>(f2k + off[t], dsk * wc[t], acc);
          if (d1 != nullptr) atomic_axpy_row<NV>(d1 + off[t], dsk * wc[t], qv);
        }
        if (d2 != nullptr && wk != 0.f) atomic_axpy_row<NV>(d2 + off[t], wk * wc[t], dv);
      }
    }
  }
  store_row<NV>(p.dfeat1 + row, acc);
}

template <typename T, int NV, bool Backward>
void launch_nv(const Params& p, cudaStream_t stream) {
  const long long queries = (long long)p.B * p.H * p.W;
  const dim3 grid((unsigned)((queries + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  if constexpr (Backward)
    epipolar_attention_backward_kernel<T, NV><<<grid, block, 0, stream>>>(p);
  else
    epipolar_attention_kernel<T, NV><<<grid, block, 0, stream>>>(p);
}

template <typename T, bool Backward>
cudaError_t launch(const Params& p, int C, cudaStream_t stream) {
  switch (C) {
    case 32: launch_nv<T, 1, Backward>(p, stream); break;
    case 64: launch_nv<T, 2, Backward>(p, stream); break;
    case 128: launch_nv<T, 4, Backward>(p, stream); break;
    case 256: launch_nv<T, 8, Backward>(p, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool valid_shape(int B, int H, int W, int K) {
  return B >= 1 && H >= 1 && W >= 1 && K >= 1 && K <= 32 * kMaxSlotsPerLane;
}

Params make_params(const void* f1, const void* f2k, const void* f2v,
                   const void* locs, const void* prior, int B, int H, int W,
                   int K, float scale, int use_sim, int softmax, int priormul) {
  Params p = {};
  p.f1 = f1;
  p.f2k = f2k;
  p.f2v = f2v;
  p.locs = static_cast<const float*>(locs);
  p.prior = static_cast<const float*>(prior);
  p.B = B;
  p.H = H;
  p.W = W;
  p.K = K;
  p.scale = scale;
  p.use_sim = use_sim;
  p.softmax = softmax;
  p.priormul = priormul;
  return p;
}

}  // namespace

extern "C" int epipolar_attention_forward(
    const void* f1, const void* f2k, const void* f2v, const void* locs,
    const void* prior, void* out, void* depth, int B, int H, int W, int K,
    int C, int is_bf16, float scale, int use_sim, int softmax, int priormul,
    void* stream) {
  if (!valid_shape(B, H, W, K)) return (int)cudaErrorInvalidValue;
  Params p = make_params(f1, f2k, f2v, locs, prior, B, H, W, K, scale,
                         use_sim, softmax, priormul);
  p.out = static_cast<float*>(out);
  p.depth = static_cast<float*>(depth);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16, false>(p, C, s)
                       : launch<float, false>(p, C, s));
}

// dother1 / dother2 may be null (no gradient wanted); when given they must
// hold zeros, since the kernel adds into them.
extern "C" int epipolar_attention_backward(
    const void* f1, const void* f2k, const void* f2v, const void* locs,
    const void* prior, const void* dout, void* dfeat1, void* dother1,
    void* dother2, int B, int H, int W, int K, int C, int is_bf16,
    float scale, int use_sim, int softmax, int priormul, void* stream) {
  if (!valid_shape(B, H, W, K)) return (int)cudaErrorInvalidValue;
  Params p = make_params(f1, f2k, f2v, locs, prior, B, H, W, K, scale,
                         use_sim, softmax, priormul);
  p.dout = static_cast<const float*>(dout);
  p.dfeat1 = static_cast<float*>(dfeat1);
  p.dother1 = static_cast<float*>(dother1);
  p.dother2 = static_cast<float*>(dother2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16, true>(p, C, s)
                       : launch<float, true>(p, C, s));
}

extern "C" int epipolar_attention_max_samples() { return 32 * kMaxSlotsPerLane; }
