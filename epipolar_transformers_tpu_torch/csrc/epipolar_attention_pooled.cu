// Pooled epipolar attention, forward and backward, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package computes sample-POOLING configs
// (reference modeling/layers/epipolar.py:200-213, the paper's fully
// parameterized model, configs/epipolar/keypoint_h36m_param.yaml) with plain
// gathers and einsums, and so did the port (ops/epipolar_attention.py:
// sample_stack).  That chain materialises the sample stack: for keys and
// values alike an f32 (B, K, HW, C) tensor a corner, 2.15 GB each at the
// param cell's shape (B=16, 64x64, K=64, C=128), passed over tens of times a
// step under autograd; it took ~80% of the param model's train step on an
// H100.  These kernels compute the same function without writing a
// per-sample stack to device memory.
//
// What they compute, for query q of item b and slot s < S = K/2, with the
// bilinear corners c (rows r_c, weights w_c) of samples s and s + S:
//
//   kA[ch] = sum_c w_c keys[r_c, ch] at sample s, kB the same at s + S
//   pk[ch] = max(kA[ch], kB[ch])                  (pv the same for the values)
//   sim_s  = <q, pk>;  logit_s = scale * (sim_s == 0 ? -1e10 : sim_s)
//   p      = softmax_s(logit);  out[ch] = sum_s p_s pv_s[ch]
//
// and the gradients of sum(out * dout), with torch.maximum's rule through
// the per-channel max (the winning member takes the gradient, an exact tie
// gives each half):
//
//   g_s  = <dout, pv_s>;  ds_s = (p_s (g_s - sum_j p_j g_j)) * scale,
//          0 where sim_s == 0
//   dq   = sum_s ds_s pk_s
//   dkeys[r, ch]   = sum over (q, s, member, c) with r_c = r of
//                    ((ds_s q[ch]) * f_member[ch]) * w_c
//   dvalues[r, ch] = the same with p_s dout[ch] and the values' winners
//
// Precision is the plain path's: the bilinear sums are formed with the
// plain path's products and sums in its order (so pk, the winners and the
// zero test agree with it bit for bit), and everything else runs in f32 on
// CUDA cores: no tensor cores, no TF32, and no rounding of a pooled vector,
// a weight or dout below f32.  Only the sums' order differs.  The width is
// the param model's, C = 128; the features are f32 or bf16.
//
// What bounds it.  reference/param.py:attention_bound puts the least time
// of one forward plus backward at the cell's shape and rig at ~75 us, set
// by the bytes (the bf16 features and the f32 locations).  The work is a
// gather: every slot reads 8 corner rows of the keys and 8 of the values
// (256 B each in bf16), 65,536 queries x 32 slots x 16 rows = 8.6 GB of
// row reads a pass.  A warp per query reading them through L1 and L2 is
// bound by that gather bandwidth, not by HBM or FLOPs.
//
// The design:
//
//   query_kernel: one warp per query, 8 consecutive queries a block, so
//     neighbouring queries (whose epipolar lines are neighbours, and touch
//     the same rows) share L1.  Lane s owns slot s (K <= 64), lanes own 4
//     channels each: a table of the 2S samples' corners in shared memory,
//     a sweep over the slots forming kA/kB/pk from the 8 corner rows and
//     reducing the dot with a butterfly, the softmax over the slots in the
//     warp, then a sweep over the values.  The backward runs the same
//     code: the values' sweep for g and the winner bits, then the keys'
//     for sim, ds and dq, writing ds and two bits a channel (member A
//     takes, member B takes; both on a tie) per slot for keys and values.
//     It reads the forward's weights p, so it does not recompute the
//     softmax, and writes each sample's base row and live corners for the
//     scatter.  (The flagship's line sort and shared-memory tiles, tried
//     here first, ran slower at the rig: forward 1.46 against 1.19 ms,
//     forward and backward 7.48 against 6.85 ms, bf16 at the cell's shape
//     on an H100.)
//   The key and value gradients, by rows, with no float atomics:
//   bucket_kernel (count), scan_kernel, bucket_kernel (fill): each item's
//     samples listed by the chunk of 2 x 4 pixels (8 key rows) that each
//     of their live corners lies in, a stable counting sort (one warp a
//     segment of 1,024 samples, equal chunks ranked with __match_any_sync;
//     the scan a tile of 4,096 counts at a time).  A sample's 2 x 2 corners
//     reach 1.875 chunks on average, against 2.25 for chunks of 8 pixels in
//     a row, so the lists hold fewer entries ("hits") and each hit more of
//     its terms.
//   scatter_kernel: one CTA of 4 warps per (chunk, item); warp w takes the
//     hits w, w + 4, ... of the chunk's list in order and sums their terms
//     ((ds_s q) * f) * w_c and ((p_s dout) * f) * w_c in registers: all 8
//     rows x both gradients x 4 channels a lane.  One warp-uniform switch
//     on the pattern of a hit's live rows (a 2 x 2 block, a pair, one; a
//     test a row otherwise) picks their sums.  The gathers stay in flight:
//     each round of 32 hits, lane l computes hit l's corners, weights and
//     coefficients from the locations, ds and p it loaded a round before,
//     and cp.async copies each group of 8 hits' query rows, dout rows and
//     winner bits (4 lanes a hit) while the group before is summed; a
//     group without a tie takes the shares without its test.  No barrier
//     stands between the warps until the end, where each row adds the 4
//     warps' sums in warp order: every (row, channel) sums its terms in one
//     fixed order, and the warps share the work evenly whatever rows the
//     hits crowd.
//     Measured at the param cell's shape (bf16, the rig's lines; an H100):
//     the design before this one (chunks of 8 rows, a shared-memory
//     read-modify-write a term, synchronously staged batches, three
//     barriers a batch) took 3.97 ms a call, 3.65 without its
//     read-modify-writes and 2.94 without its staging loads.  This one
//     takes ~1.34 ms and is bound by its instructions (~100 warp
//     instructions a hit: the shares through the winner bits, the
//     dispatch, 16 flops a term), not by its gathers or shared memory.

// Nothing writes a per-sample stack: besides the inputs and outputs, the
// forward writes the (B, S, HW) f32 weights (kept for the backward and
// `depth`) and the (B, HW) ranks; the backward writes ds (B, HW, S) f32,
// the winner bits (B, HW, S, 32 lanes, 2 bits a channel) of keys and
// values, each sample's base row and live corners (B, HW, K) and the
// chunks' lists (at most 4 ints a sample).
//
// Every run gives the same bits: each sum has a fixed order, and no kernel
// uses atomics (the bucketing ranks with warp votes).
//
// Scratch comes from the caller (pooled_backward_scratch_bytes).  Plain C
// entry points (loaded with ctypes); each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e10f;  // reference epipolar.py:298
constexpr unsigned kFull = 0xffffffffu;
constexpr int kC = 128;            // channels of queries, keys and values
constexpr int kNV = kC / 32;       // channels a lane
constexpr int kMaxK = 64;          // samples a query: S = K/2 <= 32 slots, one a lane
constexpr int kMaxHW = 16384;      // key rows of an item (16-bit base rows in `rows`)
constexpr int kWarps = 8;          // warps per block of the query kernel
constexpr int kChunkH = 2, kChunkW = 4;  // a scatter chunk: 2 x 4 pixels
constexpr int kChunkRows = kChunkH * kChunkW;  // its key rows
constexpr int kScatterWarps = 4;   // warp w of a chunk takes its hits w, w + 4, ...
constexpr int kScatterThreads = kScatterWarps * 32;
constexpr int kGroup = 8;          // hits a scatter warp stages at once, 4 lanes a hit
constexpr unsigned kNoRows = 0xffffffffu;
constexpr int kSegment = 1024;     // samples a warp of the bucketing takes
constexpr int kScanThreads = 1024;

using Mask = uint8_t;  // a lane's winner bits of one slot: 2 a channel

// An item's scatter chunks, and the chunk of pixel (y, x).
__host__ __device__ __forceinline__ int chunk_count(int H, int W) {
  return ((H + kChunkH - 1) / kChunkH) * ((W + kChunkW - 1) / kChunkW);
}

__device__ __forceinline__ int chunk_of(int y, int x, int W) {
  return (y / kChunkH) * ((W + kChunkW - 1) / kChunkW) + x / kChunkW;
}

struct Args {
  const void* q;       // (B, HW, C) queries
  const void* k;       // (B, HW, C) keys
  const void* v;       // (B, HW, C) values (== k when they are one tensor)
  const float* locs;   // (B, K, HW, 2) normalized (-1, 1) sample locations
  void* out;           // forward: (B, HW, C)
  float* weights;      // (B, S, HW): written by the forward, read by the backward
  float* rank;         // forward: (B, HW) each query's largest logit
  const void* dout;    // backward: (B, HW, C)
  void* dq;            // backward: (B, HW, C)
  void* dk;            // backward: (B, HW, C); dkeys + dvalues when fused
  void* dv;            // backward: (B, HW, C), or null when fused
  float* ds;           // backward: (B, HW, S)
  Mask* kmask;         // backward: (B, HW, S, 32) winner bits of the keys
  Mask* vmask;         // backward: (B, HW, S, 32) winner bits of the values
  unsigned* rows;      // backward: (B, HW, K) base row | live corners << 16 of a sample
  int* table;          // backward: (B, chunks, segments) entry counts, then offsets
  int* entries;        // backward: (B, HW * K * 4) samples, by chunk
  int B, H, W, K;
  float scale;
};

// quad_gather.axis_slot_weights: base in [0, size-1]; w0/w1 the weights of
// the slot-0/slot-1 corners, zero for a corner outside [0, size-1].
__device__ __forceinline__ void axis_slot_weights(float coord, int size, int& base,
                                                  float& w0, float& w1) {
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

// The corners of the sample at normalized location (lx, ly)
// (quad_gather.corner_data): rows and weights in the slot order 00, 01, 10,
// 11; a zero-weight corner's row may lie off the image and is never read.
// Live corners lie on distinct rows (a side of one pixel has no second
// corner).
__device__ __forceinline__ void corners_at(float lx, float ly, int H, int W, int (&row)[4],
                                           float (&w)[4]) {
  // align_corners=True unnormalize, as the plain path computes it
  const float x = (lx + 1.0f) / 2.0f * (float)(W - 1);
  const float y = (ly + 1.0f) / 2.0f * (float)(H - 1);
  int xb, yb;
  float x0, x1, y0, y1;
  axis_slot_weights(x, W, xb, x0, x1);
  axis_slot_weights(y, H, yb, y0, y1);
  const int base = yb * W + xb;
  row[0] = base;
  row[1] = base + 1;
  row[2] = base + W;
  row[3] = base + W + 1;
  w[0] = y0 * x0;
  w[1] = y0 * x1;
  w[2] = y1 * x0;
  w[3] = y1 * x1;
}

// The corners of sample k of query q.
__device__ __forceinline__ void sample_corners(const Args& a, int b, int q, int k,
                                               int (&row)[4], float (&w)[4]) {
  const float* l = a.locs + (((size_t)b * a.K + k) * a.H * a.W + q) * 2;
  corners_at(l[0], l[1], a.H, a.W, row, w);
}

__device__ __forceinline__ void load_row(const float* p, float (&v)[kNV]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&v)[kNV]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
  const float2 x = __bfloat1622float2(h[0]);
  const float2 y = __bfloat1622float2(h[1]);
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}

__device__ __forceinline__ void store_row(float* p, const float (&v)[kNV]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&v)[kNV]) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&h0);
  u.y = *reinterpret_cast<const unsigned*>(&h1);
  *reinterpret_cast<uint2*>(p) = u;
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

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// A query's corner table, in shared memory: for each of its K samples the
// four corners' rows and weights.
struct Table {
  int4* idx;   // (K)
  float4* w;   // (K)
};

// One member of a slot: sum_c w_c rows[idx_c], with the plain path's
// products and sums in its order; a zero-weight corner reads nothing.
template <typename T>
__device__ __forceinline__ void member(const T* base, int4 idx, float4 w, int lane,
                                       float (&acc)[kNV]) {
  float r[4][kNV];
  const int id[4] = {idx.x, idx.y, idx.z, idx.w};
  const float wc[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (wc[c] != 0.f) {
      load_row(base + (size_t)id[c] * kC + lane * kNV, r[c]);
    } else {
#pragma unroll
      for (int j = 0; j < kNV; ++j) r[c][j] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    float s = __fadd_rn(__fmul_rn(r[0][j], wc[0]), __fmul_rn(r[1][j], wc[1]));
    s = __fadd_rn(s, __fmul_rn(r[2][j], wc[2]));
    acc[j] = __fadd_rn(s, __fmul_rn(r[3][j], wc[3]));
  }
}

// The pooled vector of slot s (max of its two members, per channel) and,
// for the backward, the winner bits: bit 2j where member A takes channel
// j's gradient (A >= B), bit 2j + 1 where member B does (B >= A).
template <typename T>
__device__ __forceinline__ unsigned pooled(const T* base, const Table& t, int s, int S,
                                           int lane, float (&pk)[kNV]) {
  float A[kNV], Bm[kNV];
  member<T>(base, t.idx[s], t.w[s], lane, A);
  member<T>(base, t.idx[s + S], t.w[s + S], lane, Bm);
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    pk[j] = fmaxf(A[j], Bm[j]);
    bits |= (unsigned)(A[j] >= Bm[j]) << (2 * j);
    bits |= (unsigned)(Bm[j] >= A[j]) << (2 * j + 1);
  }
  return bits;
}

// Lane l < S writes the table entries of samples l and l + S.  The
// backward also writes each sample's base row and live corners for the
// scatter.
template <bool Bwd>
__device__ __forceinline__ void build_table(const Args& a, int b, int q, int lane,
                                            const Table& t) {
  const int S = a.K / 2;
  if (lane < S) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int k = lane + m * S;
      int row[4];
      float w[4];
      sample_corners(a, b, q, k, row, w);
      int idx[4];
      unsigned live = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        idx[c] = w[c] == 0.f ? 0 : row[c];
        live |= (unsigned)(w[c] != 0.f) << c;
      }
      t.idx[k] = make_int4(idx[0], idx[1], idx[2], idx[3]);
      t.w[k] = make_float4(w[0], w[1], w[2], w[3]);
      if (Bwd) {
        const size_t at = ((size_t)b * a.H * a.W + q) * a.K + k;
        a.rows[at] = live == 0u ? kNoRows : (unsigned)row[0] | (live << 16);
      }
    }
  }
  __syncwarp();
}

// One warp per query: the forward (weights, rank, out) or the backward (ds,
// dq and the winner bits), reading the item's key and value rows from
// device memory.
template <typename T, bool Bwd>
__global__ void __launch_bounds__(kWarps * 32) query_kernel(const Args a) {
  __shared__ int4 tidx[kWarps][kMaxK];
  __shared__ float4 tw[kWarps][kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int HW = a.H * a.W, S = a.K / 2;
  const long long gq = (long long)blockIdx.x * kWarps + warp;
  if (gq >= (long long)a.B * HW) return;  // uniform across the warp
  const int b = (int)(gq / HW), q = (int)(gq - (long long)b * HW);
  const size_t item = (size_t)b * HW * kC;
  const T* kb = static_cast<const T*>(a.k) + item;
  const T* vb = static_cast<const T*>(a.v) + item;
  const Table t{tidx[warp], tw[warp]};
  const size_t qrow = (size_t)gq * kC + lane * kNV;
  build_table<Bwd>(a, b, q, lane, t);
  float qv[kNV];
  load_row(static_cast<const T*>(a.q) + qrow, qv);

  if (!Bwd) {
    float sim = 0.f;
    for (int s = 0; s < S; ++s) {
      float pk[kNV];
      pooled<T>(kb, t, s, S, lane, pk);
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < kNV; ++j) d = fmaf(qv[j], pk[j], d);
      d = warp_sum(d);
      if (lane == s) sim = d;
    }
    const float logit = lane < S ? (sim == 0.f ? kNegInf : sim) * a.scale : -INFINITY;
    const float mx = warp_max(logit);
    const float e = lane < S ? expf(logit - mx) : 0.f;
    const float p = e / warp_sum(e);
    if (lane < S) a.weights[((size_t)b * S + lane) * HW + q] = p;
    if (lane == 0) a.rank[gq] = mx;
    float o[kNV];
#pragma unroll
    for (int j = 0; j < kNV; ++j) o[j] = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ps = __shfl_sync(kFull, p, s);
      if (ps == 0.f) continue;  // warp-uniform
      float pv[kNV];
      pooled<T>(vb, t, s, S, lane, pv);
#pragma unroll
      for (int j = 0; j < kNV; ++j) o[j] = fmaf(ps, pv[j], o[j]);
    }
    store_row(static_cast<T*>(a.out) + qrow, o);
    return;
  }

  float dout[kNV];
  load_row(static_cast<const T*>(a.dout) + qrow, dout);
  const float p = lane < S ? a.weights[((size_t)b * S + lane) * HW + q] : 0.f;
  const size_t mrow = (size_t)gq * S;
  float g = 0.f;
  for (int s = 0; s < S; ++s) {
    float pv[kNV];
    const unsigned m = pooled<T>(vb, t, s, S, lane, pv);
    a.vmask[(mrow + s) * 32 + lane] = (Mask)m;
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) d = fmaf(dout[j], pv[j], d);
    d = warp_sum(d);
    if (lane == s) g = d;
  }
  const float pg = warp_sum(p * g);
  float dsl = 0.f, dq[kNV];
#pragma unroll
  for (int j = 0; j < kNV; ++j) dq[j] = 0.f;
  for (int s = 0; s < S; ++s) {
    float pk[kNV];
    const unsigned m = pooled<T>(kb, t, s, S, lane, pk);
    a.kmask[(mrow + s) * 32 + lane] = (Mask)m;
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) d = fmaf(qv[j], pk[j], d);
    d = warp_sum(d);
    const float ps = __shfl_sync(kFull, p, s), gs = __shfl_sync(kFull, g, s);
    // softmax backward, the scale, then the zero-sentinel mask
    const float ds = d == 0.f ? 0.f : (ps * (gs - pg)) * a.scale;
    if (lane == s) dsl = ds;
#pragma unroll
    for (int j = 0; j < kNV; ++j) dq[j] = fmaf(ds, pk[j], dq[j]);
  }
  if (lane < S) a.ds[mrow + lane] = dsl;
  store_row(static_cast<T*>(a.dq) + qrow, dq);
}

// ---- the key and value gradients -------------------------------------------

// The samples of each chunk, in a fixed order, without atomics: one warp
// per segment of kSegment consecutive samples of an item walks them 32 at a
// time and, for each of a sample's live corners whose chunk no earlier live
// corner of it has, ranks equal chunks with __match_any_sync.  The counting
// pass (Fill false) writes the (chunk, segment) counts; after scan_kernel
// turns them into offsets, the fill pass writes each sample's index there,
// so a chunk's list runs by segment, then step, then corner, then lane.
template <bool Fill>
__global__ void __launch_bounds__(32) bucket_kernel(const Args a) {
  extern __shared__ int cursor[];  // chunks
  const int HW = a.H * a.W, total = HW * a.K;
  const int chunks = chunk_count(a.H, a.W), segments = (total + kSegment - 1) / kSegment;
  const int b = blockIdx.y, seg = blockIdx.x, lane = threadIdx.x;
  int* table = a.table + (size_t)b * (chunks * segments + 1) + seg;
  for (int c = lane; c < chunks; c += 32) cursor[c] = Fill ? table[(size_t)c * segments] : 0;
  __syncwarp();
  const unsigned* keys = a.rows + (size_t)b * total;
  int* out = a.entries + (size_t)b * total * 4;
  const unsigned lower = (1u << lane) - 1u;
  for (int i = 0; i < kSegment; i += 32) {
    const int e = seg * kSegment + i + lane;
    const unsigned key = e < total ? keys[e] : kNoRows;
    const int base = (int)(key & 0xffffu), y = base / a.W, x = base - y * a.W;
    const unsigned live = key == kNoRows ? 0u : key >> 16;
    // the chunks of the sample's live corners (-1 for a dead one)
    int cs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cs[j] = (live >> j) & 1u ? chunk_of(y + (j >> 1), x + (j & 1), a.W) : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c = cs[j];  // listed once a chunk: at its first live corner there
#pragma unroll
      for (int k = 0; k < j; ++k)
        if (cs[k] == c) c = -1;
      const unsigned peers = __match_any_sync(kFull, c);
      const int at = c >= 0 ? cursor[c] + __popc(peers & lower) : 0;
      __syncwarp();
      if (c >= 0) {
        if (Fill) out[at] = e;
        if ((peers & lower) == 0u) cursor[c] += __popc(peers);
      }
      __syncwarp();
    }
  }
  if (!Fill)
    for (int c = lane; c < chunks; c += 32) table[(size_t)c * segments] = cursor[c];
}

// One block per item: the (chunk, segment) counts, chunk-major, to their
// exclusive prefix, and the item's count of entries after them: each
// chunk's list starts at its first segment's offset.  The block takes
// kScanThreads x 4 counts at a time, 4 consecutive ones a thread.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(const Args a) {
  __shared__ int warp_total[kScanThreads / 32];
  const int HW = a.H * a.W, total = HW * a.K;
  const int n = chunk_count(a.H, a.W) * ((total + kSegment - 1) / kSegment);
  int* v = a.table + (size_t)blockIdx.x * (n + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;  // the counts before this tile
  for (int base = 0; base < n; base += 4 * kScanThreads) {
    const int i = base + 4 * (int)threadIdx.x;
    int x[4], sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = i + j < n ? v[i + j] : 0;
      sum += x[j];
    }
    const int incl = warp_inclusive_scan(sum, lane);
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_total[lane] = warp_inclusive_scan(warp_total[lane], lane);
    __syncthreads();
    int run = carry + incl - sum + (warp > 0 ? warp_total[warp - 1] : 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j < n) v[i + j] = run;
      run += x[j];
    }
    carry += warp_total[kScanThreads / 32 - 1];
    __syncthreads();  // every thread has read warp_total before the next tile
  }
  if (threadIdx.x == 0) v[n] = carry;
}

// cp.async of 16 bytes to a shared-memory address, through L1: a query's
// rows are read again by the hits of that query that follow.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Loads from shared-memory addresses.
__device__ __forceinline__ unsigned lds_u8(unsigned at) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(at));
  return v;
}

__device__ __forceinline__ float lds_f32(unsigned at) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(at));
  return v;
}

__device__ __forceinline__ uint4 lds_u4(unsigned at) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(at));
  return v;
}

// A lane's 4 channels of a staged row, as f32.
template <typename T>
__device__ __forceinline__ void lds_row(unsigned at, float (&v)[kNV]) {
  if constexpr (sizeof(T) == 4) {
    const uint4 u = lds_u4(at);
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  } else {
    unsigned x, y;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(x), "=r"(y) : "r"(at));
    // a bf16 is the high half of its f32
    v[0] = __uint_as_float(x << 16); v[1] = __uint_as_float(x & 0xffff0000u);
    v[2] = __uint_as_float(y << 16); v[3] = __uint_as_float(y & 0xffff0000u);
  }
}

// What a warp needs of one hit to sum it: ds (keys) and p (values) of its
// slot; `rows`, bit r set where a live corner lies on the chunk's row r,
// bit 8 the member (B); and w[r] that corner's weight (set only there).
struct HitMeta {
  float coef[2];
  unsigned rows, pad;
  float w[kChunkRows];
};

// A warp's shared memory in the scatter: two groups of kGroup staged hits,
// each its query row, dout row and the two sets of winner bits of its
// slot, then a round's HitMeta.  At the end the CTA's shared memory holds
// each warp's sums instead.
template <typename T>
struct ScatterShape {
  static constexpr int kVec = kC * (int)sizeof(T), kMask = 32 * (int)sizeof(Mask);
  static constexpr int kSlot = 2 * kVec + 2 * kMask;
  static constexpr int kGroupBytes = kGroup * kSlot;
  static constexpr int kWarpBytes = 2 * kGroupBytes + 32 * (int)sizeof(HitMeta);
  static constexpr size_t kSums = (size_t)kScatterWarps * 2 * kChunkRows * kC * sizeof(float);
  static constexpr size_t kBytes =
      kSums > (size_t)kScatterWarps * kWarpBytes ? kSums : (size_t)kScatterWarps * kWarpBytes;
};

// A hit's entry (a sample's index in its item) as (query << 6) | (member
// << 5) | slot, or -1 past the end of a warp's hits.
__device__ __forceinline__ int pack_hit(int e, int K) {
  if (e < 0) return -1;
  const int S = K / 2, q = e / K, k = e - q * K;
  return (q << 6) | (k < S ? k : (k - S) | 32);
}

// Start the copies of a group of hits into a staging buffer: lanes 4h to
// 4h + 3 copy hit h (packed as pack_hit, -1 for none), lane 4h + part its
// pieces part, part + 4, ... of 16 bytes: the query row, the dout row,
// then the winner bits (parts 0-1 the keys', 2-3 the values').
template <typename T>
__device__ __forceinline__ void stage_group(const Args& a, int b, int hit, unsigned to,
                                            int lane) {
  using Shape = ScatterShape<T>;
  constexpr int kRow = Shape::kVec / 64;  // a row's pieces a lane
  if (hit < 0) return;
  const int part = lane & 3, S = a.K / 2;
  const size_t item_q = (size_t)b * a.H * a.W + ((unsigned)hit >> 6);
  const unsigned char* q = static_cast<const unsigned char*>(a.q) + item_q * Shape::kVec;
  const unsigned char* d = static_cast<const unsigned char*>(a.dout) + item_q * Shape::kVec;
  const unsigned char* m = (part < 2 ? a.kmask : a.vmask) +
                           (item_q * S + (hit & 31)) * Shape::kMask + (part & 1) * 16;
  to += (lane >> 2) * Shape::kSlot + part * 16;
#pragma unroll
  for (int i = 0; i < kRow; ++i) cp_async16(to + i * 64, q + part * 16 + i * 64);
#pragma unroll
  for (int i = 0; i < kRow; ++i) cp_async16(to + Shape::kVec + i * 64, d + part * 16 + i * 64);
  cp_async16(to + 2 * Shape::kVec, m);  // kmask's bytes, then vmask's
}

// acc[r] += x * w, channel by channel, for keys and values: the product
// rounded, then the sum.
__device__ __forceinline__ void add_row(float (&k)[kNV], float (&v)[kNV], const float (&xk)[kNV],
                                        const float (&xv)[kNV], float w) {
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    k[j] = __fadd_rn(k[j], __fmul_rn(xk[j], w));
    v[j] = __fadd_rn(v[j], __fmul_rn(xv[j], w));
  }
}

// A member's share of coef x[j]: all of it where it takes channel j (bit
// 2j of `own`), half where both members do (bit 2j of `tie`), else 0.
template <bool Tie>
__device__ __forceinline__ void share(unsigned own, unsigned tie, float coef,
                                      const float (&x)[kNV], float (&out)[kNV]) {
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    const float cx = __fmul_rn(coef, x[j]);
    if (Tie) {
      out[j] = (own >> (2 * j)) & 1u ? ((tie >> (2 * j)) & 1u ? __fmul_rn(cx, 0.5f) : cx) : 0.f;
    } else {
      out[j] = (own >> (2 * j)) & 1u ? cx : 0.f;
    }
  }
}

// One CTA per (chunk of kChunkH x kChunkW pixels, item); warp w takes the
// hits w, w + kScatterWarps, ... of the chunk's list, in order, and sums
// their terms into registers: 8 rows x 2 gradients x 4 channels a lane.
// Its hits are taken in rounds of 32: at a round's start lane l works out
// hit l's live corners in the chunk, weights and coefficients from the
// locations, ds and p loaded during the round before, and starts the loads
// of the next round's.  The hits' query rows, dout rows and winner bits
// are copied by cp.async kGroup hits at a time, a group ahead of the one
// being summed.  No barrier stands between the warps until the end, where
// each row adds the warps' sums in warp order.  So every (row, channel)
// sums its terms in one fixed order, and the warps share the work whatever
// rows the hits hold.  Every row of the chunk inside the image is written.
template <typename T>
__global__ void __launch_bounds__(kScatterThreads, 4) scatter_kernel(const Args a) {
  using Shape = ScatterShape<T>;
  constexpr int R = kChunkRows;
  extern __shared__ __align__(16) unsigned char scatter_smem[];
  const int HW = a.H * a.W, K = a.K, S = K / 2, total = HW * K;
  const int chunks = chunk_count(a.H, a.W), segments = (total + kSegment - 1) / kSegment;
  const int b = blockIdx.y, chunk = blockIdx.x, cw = (a.W + kChunkW - 1) / kChunkW;
  // the chunk's pixels: row r at (y0 + r / kChunkW, x0 + r % kChunkW)
  const int y0 = chunk / cw * kChunkH, x0 = chunk % cw * kChunkW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* stage = scatter_smem + (size_t)warp * Shape::kWarpBytes;
  HitMeta* meta = reinterpret_cast<HitMeta*>(stage + 2 * Shape::kGroupBytes);
  const unsigned stage_at = (unsigned)__cvta_generic_to_shared(stage);
  const unsigned meta_at = (unsigned)__cvta_generic_to_shared(meta);
  const int* table = a.table + (size_t)b * (chunks * segments + 1);
  const int first = table[(size_t)chunk * segments];
  // the next chunk's first offset, or the item's count of entries
  const int n = table[(size_t)(chunk + 1) * segments] - first;
  const int* list = a.entries + (size_t)b * total * 4 + first + warp;
  const int mine = n > warp ? (n - warp + kScatterWarps - 1) / kScatterWarps : 0;

  float acc[2][R][kNV];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kNV; ++j) acc[0][r][j] = acc[1][r][j] = 0.f;

  // lane l's hit t of this warp's list, or -1 past its end
  const auto entry = [&](int t) { return t < mine ? list[(size_t)t * kScatterWarps] : -1; };
  // lane l's hit of the next round: its packed index, location, ds and p
  int next = -1;
  float2 loc = make_float2(0.f, 0.f);
  float ds = 0.f, p = 0.f;
  const auto load_next = [&](int e) {
    next = pack_hit(e, K);
    if (next >= 0) {
      const int q = next >> 6, s = next & 31, k = s + (next & 32 ? S : 0);
      loc = *reinterpret_cast<const float2*>(a.locs + (((size_t)b * K + k) * HW + q) * 2);
      ds = a.ds[((size_t)b * HW + q) * S + s];
      p = a.weights[((size_t)b * S + s) * HW + q];
    }
  };
  load_next(entry(lane));
  int after = entry(32 + lane);  // the entry of lane l's hit in the round after the next

  for (int t0 = 0; t0 < mine; t0 += 32) {
    // this round's hits, one a lane, from what the last round loaded
    const int cur = next;
    if (cur >= 0) {
      int row[4];
      float w[4];
      corners_at(loc.x, loc.y, a.H, a.W, row, w);
      // corner c at pixel (y + c / 2, x + c % 2), relative to the chunk's
      const int y = row[0] / a.W - y0, x = row[0] - (row[0] / a.W) * a.W - x0;
      unsigned rows = (unsigned)(cur & 32) << 3;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int yc = y + (c >> 1), xc = x + (c & 1);
        if (w[c] != 0.f && yc >= 0 && yc < kChunkH && xc >= 0 && xc < kChunkW) {
          meta[lane].w[yc * kChunkW + xc] = w[c];
          rows |= 1u << (yc * kChunkW + xc);
        }
      }
      meta[lane].rows = rows;
      meta[lane].coef[0] = ds;
      meta[lane].coef[1] = p;
    }
    // the next round's loads, and the entries of the round after it
    load_next(after);
    after = entry(t0 + 64 + lane);
    __syncwarp();
    if (t0 == 0) {
      stage_group<T>(a, b, __shfl_sync(kFull, cur, lane >> 2), stage_at, lane);
      cp_async_commit();
    }
    for (int g = 0; g < 32 && t0 + g < mine; g += kGroup) {
      // start the copies of the next group (this round's or the next's)
      const int ahead = __shfl_sync(kFull, g + kGroup < 32 ? cur : next,
                                    ((g + kGroup) & 31) + (lane >> 2));
      stage_group<T>(a, b, ahead,
                     stage_at + (((t0 + g) / kGroup + 1) & 1) * Shape::kGroupBytes, lane);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();  // every lane's copies of this group have landed
      const unsigned group = stage_at + (((t0 + g) / kGroup) & 1) * Shape::kGroupBytes;
      const int end = min(kGroup, mine - t0 - g);
      // whether any hit of the group has a tie: lane 4h + part looks at 16
      // of hit h's 64 bytes of winner bits
      const uint4 wb =
          lds_u4(group + (lane >> 2) * Shape::kSlot + 2 * Shape::kVec + (lane & 3) * 16);
      const unsigned both = (wb.x & (wb.x >> 1)) | (wb.y & (wb.y >> 1)) | (wb.z & (wb.z >> 1)) |
                            (wb.w & (wb.w >> 1));
      const bool ties = __any_sync(kFull, (lane >> 2) < end && (both & 0x55555555u));
      const auto sum_group = [&](auto tie) {
        for (int i = 0; i < end; ++i) {
          const unsigned slot = group + i * Shape::kSlot;
          const unsigned h = meta_at + (g + i) * (unsigned)sizeof(HitMeta);
          const uint4 head = lds_u4(h);  // coef[0], coef[1], rows
          const unsigned rows = head.z;
          float xq[kNV], xd[kNV];
          lds_row<T>(slot + lane * (Shape::kVec / 32), xq);
          lds_row<T>(slot + Shape::kVec + lane * (Shape::kVec / 32), xd);
          // the winner bits: bit 2j member A takes channel j, bit 2j + 1
          // member B does (both on a tie)
          const unsigned mk = lds_u8(slot + 2 * Shape::kVec + lane);
          const unsigned mv = lds_u8(slot + 2 * Shape::kVec + Shape::kMask + lane);
          const unsigned member = (rows >> R) & 1u;
          float xk[kNV], xv[kNV];
          constexpr bool kTie = decltype(tie)::value;
          share<kTie>(mk >> member, mk & (mk >> 1), __uint_as_float(head.x), xq, xk);
          share<kTie>(mv >> member, mv & (mv >> 1), __uint_as_float(head.y), xd, xv);
          // the rows its live corners lie on: one warp-uniform dispatch on
          // their pattern (a whole 2 x 2 block of corners, a row pair, a
          // column pair, one), or a test a row
          const unsigned wat = h + offsetof(HitMeta, w);
#define ROW(F) add_row(acc[0][F], acc[1][F], xk, xv, lds_f32(wat + 4 * (F)))
          switch (rows & 0xffu) {
            case 0x33: ROW(0); ROW(1); ROW(4); ROW(5); break;
            case 0x66: ROW(1); ROW(2); ROW(5); ROW(6); break;
            case 0xcc: ROW(2); ROW(3); ROW(6); ROW(7); break;
            case 0x03: ROW(0); ROW(1); break;
            case 0x06: ROW(1); ROW(2); break;
            case 0x0c: ROW(2); ROW(3); break;
            case 0x30: ROW(4); ROW(5); break;
            case 0x60: ROW(5); ROW(6); break;
            case 0xc0: ROW(6); ROW(7); break;
            case 0x11: ROW(0); ROW(4); break;
            case 0x22: ROW(1); ROW(5); break;
            case 0x44: ROW(2); ROW(6); break;
            case 0x88: ROW(3); ROW(7); break;
            case 0x01: ROW(0); break;
            case 0x02: ROW(1); break;
            case 0x04: ROW(2); break;
            case 0x08: ROW(3); break;
            case 0x10: ROW(4); break;
            case 0x20: ROW(5); break;
            case 0x40: ROW(6); break;
            case 0x80: ROW(7); break;
            default:
#pragma unroll
              for (int r = 0; r < R; ++r)
                if (rows & (1u << r)) ROW(r);
          }
#undef ROW
        }
      };
      // a tie is rare: the groups without one take the shares without its test
      if (ties) {
        sum_group(std::true_type{});
      } else {
        sum_group(std::false_type{});
      }
      __syncwarp();  // the group is read before a later group's copies reuse its buffer
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  __syncthreads();  // every warp is done with its staging: the sums take its place
  float* sums = reinterpret_cast<float*>(scatter_smem);  // (warp, gradient, R, C)
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r)
      store_row(sums + ((size_t)(warp * 2 + g) * R + r) * kC + lane * kNV, acc[g][r]);
  __syncthreads();
  const bool fused = a.dv == nullptr;
  // each row: the warps' sums of each gradient in warp order; keys and
  // values one tensor: the keys' sum plus the values'
  for (int i = threadIdx.x; i < R * 32; i += kScatterThreads) {
    const int r = i >> 5, c = (i & 31) * kNV;
    const int y = y0 + r / kChunkW, x = x0 + r % kChunkW;
    if (y >= a.H || x >= a.W) continue;
    float v[2][kNV];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      load_row(sums + ((size_t)g * R + r) * kC + c, v[g]);
      for (int w = 1; w < kScatterWarps; ++w) {
        float u[kNV];
        load_row(sums + ((size_t)(w * 2 + g) * R + r) * kC + c, u);
#pragma unroll
        for (int j = 0; j < kNV; ++j) v[g][j] = __fadd_rn(v[g][j], u[j]);
      }
    }
    const size_t at = ((size_t)b * HW + y * a.W + x) * kC + c;
    if (fused) {
#pragma unroll
      for (int j = 0; j < kNV; ++j) v[0][j] = __fadd_rn(v[0][j], v[1][j]);
    } else {
      store_row(static_cast<T*>(a.dv) + at, v[1]);
    }
    store_row(static_cast<T*>(a.dk) + at, v[0]);
  }
}

// ---- launches --------------------------------------------------------------

size_t align_up(size_t n) { return (n + 255) & ~(size_t)255; }

// The (chunk, segment) counts of an item's bucketing table, which holds
// the item's count of entries after them.
size_t table_counts(int H, int W, int K) {
  return (size_t)chunk_count(H, W) * (((size_t)H * W * K + kSegment - 1) / kSegment);
}

// The backward's scratch: ds, the two winner-bit sets, the row ranges, the
// bucketing's table and the chunks' lists.  `table_at`, if given, receives
// the table's byte offset.
size_t carve_backward(char* base, int B, int H, int W, int K, Args* a,
                      size_t* table_at = nullptr) {
  const int HW = H * W;
  const size_t slots = (size_t)B * HW * (K / 2);
  const size_t mask = slots * 32 * sizeof(Mask);
  const size_t samples = (size_t)B * HW * K;
  const size_t table = (size_t)B * (table_counts(H, W, K) + 1);
  const size_t pieces[] = {slots * sizeof(float), mask, mask, samples * sizeof(unsigned),
                           table * sizeof(int), samples * 4 * sizeof(int)};
  size_t off[6], used = 0;
  for (int i = 0; i < 6; ++i) {
    off[i] = used;
    used += align_up(pieces[i]);
  }
  if (table_at != nullptr) *table_at = off[4];
  if (base != nullptr) {
    a->ds = reinterpret_cast<float*>(base + off[0]);
    a->kmask = reinterpret_cast<Mask*>(base + off[1]);
    a->vmask = reinterpret_cast<Mask*>(base + off[2]);
    a->rows = reinterpret_cast<unsigned*>(base + off[3]);
    a->table = reinterpret_cast<int*>(base + off[4]);
    a->entries = reinterpret_cast<int*>(base + off[5]);
  }
  return used;
}

template <typename T, bool Bwd>
cudaError_t launch_queries(const Args& a, cudaStream_t stream) {
  const long long queries = (long long)a.B * a.H * a.W;
  query_kernel<T, Bwd><<<(unsigned)((queries + kWarps - 1) / kWarps), kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const Args& a, cudaStream_t stream) {
  cudaError_t err;
  if ((err = launch_queries<T, true>(a, stream)) != cudaSuccess) return err;
  const int HW = a.H * a.W, chunks = chunk_count(a.H, a.W);
  const dim3 segments((unsigned)(((long long)HW * a.K + kSegment - 1) / kSegment), (unsigned)a.B);
  const size_t csmem = (size_t)chunks * sizeof(int);
  bucket_kernel<false><<<segments, 32, csmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<<<a.B, kScanThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bucket_kernel<true><<<segments, 32, csmem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = ScatterShape<T>::kBytes;
  if ((err = cudaFuncSetAttribute(scatter_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  scatter_kernel<T><<<dim3((unsigned)chunks, (unsigned)a.B), kScatterThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool shape_ok(int B, int H, int W, int K, int C) {
  return B >= 1 && H >= 1 && W >= 1 && H * W <= kMaxHW && K >= 2 && K <= kMaxK && K % 2 == 0 &&
         C == kC && (long long)B * H * W * K < (1ll << 31);
}

}  // namespace

extern "C" {

int pooled_max_samples() { return kMaxK; }
int pooled_max_rows() { return kMaxHW; }
int pooled_channels() { return kC; }

long long pooled_backward_scratch_bytes(int B, int H, int W, int K) {
  return (long long)carve_backward(nullptr, B, H, W, K, nullptr);
}

// Where a backward leaves each item's count of scatter entries (the
// (sample, chunk) pairs the scatter walks) in its scratch: the byte offset
// of item 0's, and the ints from one item's to the next.
long long pooled_scatter_hits_offset(int B, int H, int W, int K) {
  size_t at = 0;
  carve_backward(nullptr, B, H, W, K, nullptr, &at);
  return (long long)(at + table_counts(H, W, K) * sizeof(int));
}

long long pooled_scatter_hits_stride(int H, int W, int K) {
  return (long long)table_counts(H, W, K) + 1;
}

// q, k, v (B, HW, C) bf16 or f32 (k == v when keys and values are one
// tensor), locs (B, K, HW, 2) f32 -> out (B, HW, C) in the features' type,
// weights (B, K/2, HW) f32, rank (B, HW) f32.  Returns a CUDA error code
// (1 for a shape the kernels do not take).
int pooled_forward(const void* q, const void* k, const void* v, const float* locs, void* out,
                   float* weights, float* rank, int B, int H, int W, int K, int C, int bf16,
                   float scale, void* stream) {
  if (!shape_ok(B, H, W, K, C)) return 1;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.locs = locs; a.out = out; a.weights = weights; a.rank = rank;
  a.B = B; a.H = H; a.W = W; a.K = K; a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_queries<__nv_bfloat16, false>(a, st) : launch_queries<float, false>(a, st);
}

// The gradients of sum(out * dout): dq, dk, dv (B, HW, C) in the features'
// type; with dv null (keys and values one tensor) dk is the sum of both.
// weights are the forward's; scratch is sized by
// pooled_backward_scratch_bytes.  Every row of each gradient is written.
int pooled_backward(const void* q, const void* k, const void* v, const float* locs,
                    float* weights, const void* dout, void* scratch, void* dq, void* dk,
                    void* dv, int B, int H, int W, int K, int C, int bf16, float scale,
                    void* stream) {
  if (!shape_ok(B, H, W, K, C)) return 1;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.locs = locs; a.weights = weights; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.W = W; a.K = K; a.scale = scale;
  carve_backward(static_cast<char*>(scratch), B, H, W, K, &a);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_backward<__nv_bfloat16>(a, st) : launch_backward<float>(a, st);
}

}  // extern "C"
