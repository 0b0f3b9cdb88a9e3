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
//     samples listed by the chunk of 8 rows that each of their live
//     corners lies in, a stable counting sort (one warp a segment of 1,024
//     samples, equal chunks ranked with __match_any_sync).
//   scatter_kernel: one CTA per (chunk, item) walks its list in order, 64
//     samples at a time: their corners, ds and p, and their query rows,
//     dout rows and winner bits staged in shared memory; key warp w and
//     value warp w of 4 take samples w, w + 4, ... and add
//     ((ds_s q) * f) * w_c, resp. ((p_s dout) * f) * w_c, into their own
//     copy of the chunk's rows (a lane its 4 channels); each row then adds
//     the four copies in warp order.  So every (row, channel) sums its
//     terms in one fixed order, and the warps share the work whatever rows
//     the samples hold.  Owning rows by warp instead ran 2.3-3x slower at
//     the rig (consecutive samples of a list lie on neighbouring lines, so
//     on the same few rows, and most warps waited), and walking all the
//     item's samples in every chunk instead of its list slower again
//     (measured on an H100).  What bounds it: an add to shared memory per
//     (sample, corner, channel), keys and values, ~4.3e9 a step at the
//     cell's shape.
//
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
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e10f;  // reference epipolar.py:298
constexpr unsigned kFull = 0xffffffffu;
constexpr int kC = 128;            // channels of queries, keys and values
constexpr int kNV = kC / 32;       // channels a lane
constexpr int kMaxK = 64;          // samples a query: S = K/2 <= 32 slots, one a lane
constexpr int kMaxHW = 16384;      // key rows of an item (16-bit base rows in `rows`)
constexpr int kWarps = 8;          // warps per block of the query kernel
constexpr int kChunkRows = 8;      // rows of a scatter chunk
constexpr int kScatterWarps = 4;   // replicas: warp w takes a batch's hits w, w + 4, ...
constexpr int kScatterThreads = 2 * kScatterWarps * 32;  // key warps, then value warps
constexpr unsigned kNoRows = 0xffffffffu;
constexpr int kSegment = 1024;     // samples a warp of the bucketing takes
constexpr int kScanThreads = 1024;

using Mask = uint8_t;  // a lane's winner bits of one slot: 2 a channel

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

// The corners of sample k of query q (quad_gather.corner_data): rows and
// weights in the slot order 00, 01, 10, 11; a zero-weight corner's row may
// lie off the image and is never read.
__device__ __forceinline__ void sample_corners(const Args& a, int b, int q, int k,
                                               int (&row)[4], float (&w)[4]) {
  const int HW = a.H * a.W;
  const float* l = a.locs + (((size_t)b * a.K + k) * HW + q) * 2;
  // align_corners=True unnormalize, as the plain path computes it
  const float x = (l[0] + 1.0f) / 2.0f * (float)(a.W - 1);
  const float y = (l[1] + 1.0f) / 2.0f * (float)(a.H - 1);
  int xb, yb;
  float x0, x1, y0, y1;
  axis_slot_weights(x, a.W, xb, x0, x1);
  axis_slot_weights(y, a.H, yb, y0, y1);
  const int base = yb * a.W + xb;
  row[0] = base;
  row[1] = base + 1;
  row[2] = base + a.W;
  row[3] = base + a.W + 1;
  w[0] = y0 * x0;
  w[1] = y0 * x1;
  w[2] = y1 * x0;
  w[3] = y1 * x1;
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

// A sample whose live rows reach a scatter chunk: its query, slot, member
// and the live corners that lie in the chunk (`tag`: bits 0-5 the slot, bit
// 6 the member, bits 8-11 the corners), its corners, and ds and p of its
// slot.
struct Hit {
  int q, tag, base;
  float w[4];
  float coef[2];
};

// The samples of each chunk, in a fixed order, without atomics: one warp
// per segment of kSegment consecutive samples of an item walks them 32 at a
// time and, for each of a sample's live corners whose chunk no earlier
// corner of it has, ranks equal chunks with __match_any_sync.  The counting
// pass (Fill false) writes the (chunk, segment) counts; after scan_kernel
// turns them into offsets, the fill pass writes each sample's index there,
// so a chunk's list runs by segment, then step, then corner, then lane.
template <bool Fill>
__global__ void __launch_bounds__(32) bucket_kernel(const Args a) {
  extern __shared__ int cursor[];  // chunks
  constexpr int R = kChunkRows;
  const int HW = a.H * a.W, total = HW * a.K;
  const int chunks = (HW + R - 1) / R, segments = (total + kSegment - 1) / kSegment;
  const int b = blockIdx.y, seg = blockIdx.x, lane = threadIdx.x;
  int* table = a.table + (size_t)b * (chunks * segments + 1) + seg;
  for (int c = lane; c < chunks; c += 32) cursor[c] = Fill ? table[(size_t)c * segments] : 0;
  __syncwarp();
  const unsigned* keys = a.rows + (size_t)b * total;
  int* out = a.entries + (size_t)b * total * 4;
  const unsigned lower = (1u << lane) - 1u;
  const int off[4] = {0, 1, a.W, a.W + 1};
  for (int i = 0; i < kSegment; i += 32) {
    const int e = seg * kSegment + i + lane;
    const unsigned key = e < total ? keys[e] : kNoRows;
    const int base = (int)(key & 0xffffu);
    const unsigned live = key == kNoRows ? 0u : key >> 16;
    int seen = -1;  // the chunk of the sample's last live corner
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cj = (base + off[j]) / R;
      const int c = ((live >> j) & 1u) && cj != seen ? cj : -1;
      if (c >= 0) seen = c;
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
// chunk's list starts at its first segment's offset.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(const Args a) {
  __shared__ int warp_total[kScanThreads / 32];
  const int HW = a.H * a.W, total = HW * a.K;
  const int n = ((HW + kChunkRows - 1) / kChunkRows) * ((total + kSegment - 1) / kSegment);
  int* v = a.table + (size_t)blockIdx.x * (n + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = (n + kScanThreads - 1) / kScanThreads;
  const int i0 = min((int)threadIdx.x * seg, n), i1 = min(i0 + seg, n);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += v[i];
  const int incl = warp_inclusive_scan(sum, lane);
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) warp_total[lane] = warp_inclusive_scan(warp_total[lane], lane);
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    const int c = v[i];
    v[i] = run;
    run += c;
  }
  if (i0 < i1 && i1 == n) v[n] = run;
}

// Copy one lane's Bytes of a staged row.
template <int Bytes>
__device__ __forceinline__ void copy_lane(unsigned char* dst, const unsigned char* src) {
  if constexpr (Bytes == 1) {
    *dst = *src;
  } else if constexpr (Bytes == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
    static_assert(Bytes == 16, "a lane copies 1, 8 or 16 bytes");
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
}

// The scatter's shared memory: each warp's own sums of both gradients of a
// chunk's rows, then a batch of hits with their query rows, dout rows and
// winner bits staged.
template <typename T>
struct ScatterShape {
  static constexpr int kVec = kC * (int)sizeof(T), kMask = 32 * (int)sizeof(Mask);
  static constexpr int kHitBytes = 2 * kVec + 2 * kMask;
  static constexpr int kBatch = 36864 / kHitBytes < 64 ? 36864 / kHitBytes : 64;
  static constexpr size_t kAcc = 2 * (size_t)kScatterWarps * kChunkRows * kC * sizeof(float);
  static constexpr size_t kStage = (size_t)kBatch * kHitBytes;
  static constexpr size_t kBytes = kAcc + kStage + kBatch * sizeof(Hit);
};

// One CTA per (chunk of kChunkRows rows, item).  The chunk's samples, in
// their list's order, are taken kBatch at a time: their slot data, query
// and dout rows and winner bits staged in shared memory (a warp a hit).
// Key warp w and value warp w take the batch's hits w, w + 4, ... in order,
// a lane its 4 channels, and sum them into their own copy of the chunk's
// rows; at the end each row adds the four copies in warp order.  So every
// (row, channel) sums its terms in one fixed order, and the warps share the
// work whatever rows the hits hold.  Every row of the chunk is written.
template <typename T>
__global__ void __launch_bounds__(kScatterThreads) scatter_kernel(const Args a) {
  using Shape = ScatterShape<T>;
  constexpr int R = kChunkRows, kBatch = Shape::kBatch;
  constexpr int kVec = Shape::kVec, kMask = Shape::kMask;
  extern __shared__ __align__(16) unsigned char scatter_smem[];
  float* acc = reinterpret_cast<float*>(scatter_smem);  // (2 gradients, 4 copies, R, C)
  unsigned char* stage = scatter_smem + Shape::kAcc;    // (kBatch, 2 vectors, 2 bit sets)
  Hit* hits = reinterpret_cast<Hit*>(stage + Shape::kStage);
  const int HW = a.H * a.W, K = a.K, S = K / 2, total = HW * K;
  const int chunks = (HW + R - 1) / R, segments = (total + kSegment - 1) / kSegment;
  const int b = blockIdx.y, chunk = blockIdx.x, r0 = chunk * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = warp / kScatterWarps, copy = warp % kScatterWarps;  // group 0: keys
  for (int i = tid; i < (int)(Shape::kAcc / 16); i += kScatterThreads)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int* table = a.table + (size_t)b * (chunks * segments + 1);
  const int first = table[(size_t)chunk * segments];
  // the next chunk's first offset, or the item's count of entries
  const int last = table[(size_t)(chunk + 1) * segments];
  const int* list = a.entries + (size_t)b * total * 4;
  const int off[4] = {0, 1, a.W, a.W + 1};
  float* mine = acc + (size_t)warp * R * kC;
  const unsigned char* qsrc = static_cast<const unsigned char*>(a.q);
  const unsigned char* dsrc = static_cast<const unsigned char*>(a.dout);
  for (int start = first; start < last; start += kBatch) {
    const int n = min(kBatch, last - start);
    __syncthreads();  // the previous batch is applied
    if (tid < n) {
      const int e = list[start + tid];
      const int q = e / K, k = e - q * K;
      const int s = k < S ? k : k - S;
      int row[4];
      float w[4];
      sample_corners(a, b, q, k, row, w);
      int tag = s | (k < S ? 0 : 64);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = row[c] - r0;
        if (w[c] != 0.f && r >= 0 && r < R) tag |= 1 << (8 + c);
      }
      hits[tid] = Hit{q, tag, row[0], {w[0], w[1], w[2], w[3]},
                      {a.ds[((size_t)b * HW + q) * S + s], a.weights[((size_t)b * S + s) * HW + q]}};
    }
    __syncthreads();
    for (int h = warp; h < n; h += kScatterThreads / 32) {
      const size_t item_q = (size_t)b * HW + hits[h].q;
      const size_t bits = (item_q * S + (hits[h].tag & 63)) * kMask;
      unsigned char* st = stage + (size_t)h * Shape::kHitBytes;
      copy_lane<kVec / 32>(st + lane * (kVec / 32), qsrc + item_q * kVec + lane * (kVec / 32));
      copy_lane<kVec / 32>(st + kVec + lane * (kVec / 32),
                           dsrc + item_q * kVec + lane * (kVec / 32));
      copy_lane<kMask / 32>(st + 2 * kVec + lane * (kMask / 32),
                            a.kmask + bits + lane * (kMask / 32));
      copy_lane<kMask / 32>(st + 2 * kVec + kMask + lane * (kMask / 32),
                            a.vmask + bits + lane * (kMask / 32));
    }
    __syncthreads();
    for (int h = copy; h < n; h += kScatterWarps) {
      const Hit& hh = hits[h];
      const float coef = hh.coef[group];
      const int tag = hh.tag;
      if (coef == 0.f) continue;  // uniform: its terms are all zero
      const unsigned char* st = stage + (size_t)h * Shape::kHitBytes;
      float x[kNV];
      load_row(reinterpret_cast<const T*>(st + group * kVec) + lane * kNV, x);
      unsigned m = reinterpret_cast<const Mask*>(st + 2 * kVec + group * kMask)[lane];
      if (tag & 64) m = ((m >> 1) & 0x55u) | ((m & 0x55u) << 1);  // member B: its bit first
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        // the member takes channel j alone: all of it; on a tie: half
        const bool own = (m >> (2 * j)) & 1u, other = (m >> (2 * j + 1)) & 1u;
        const float cx = __fmul_rn(coef, x[j]);
        x[j] = own ? (other ? __fmul_rn(cx, 0.5f) : cx) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!((tag >> (8 + c)) & 1)) continue;
        // one 16-byte access a lane: no bank conflicts
        float4* dst = reinterpret_cast<float4*>(mine + (size_t)(hh.base + off[c] - r0) * kC +
                                                lane * kNV);
        const float wc = hh.w[c];
        float4 t = *dst;
        t.x = __fadd_rn(t.x, __fmul_rn(x[0], wc));
        t.y = __fadd_rn(t.y, __fmul_rn(x[1], wc));
        t.z = __fadd_rn(t.z, __fmul_rn(x[2], wc));
        t.w = __fadd_rn(t.w, __fmul_rn(x[3], wc));
        *dst = t;
      }
    }
  }
  __syncthreads();
  const bool fused = a.dv == nullptr;
  if (fused && group == 1) return;
  T* out = static_cast<T*>(group == 0 ? a.dk : a.dv);
  // each row: the copies of its gradient in warp order (then the values'
  // copies, when keys and values are one tensor)
  for (int i = copy; i < R && r0 + i < HW; i += kScatterWarps) {
    float v[kNV];
    load_row(acc + ((size_t)group * kScatterWarps * R + i) * kC + lane * kNV, v);
    for (int w = 1; w < (fused ? 2 : 1) * kScatterWarps; ++w) {
      float u[kNV];
      load_row(acc + ((size_t)(group * kScatterWarps + w) * R + i) * kC + lane * kNV, u);
#pragma unroll
      for (int j = 0; j < kNV; ++j) v[j] = __fadd_rn(v[j], u[j]);
    }
    store_row(out + ((size_t)b * HW + r0 + i) * kC + lane * kNV, v);
  }
}

// ---- launches --------------------------------------------------------------

size_t align_up(size_t n) { return (n + 255) & ~(size_t)255; }

// The backward's scratch: ds, the two winner-bit sets, the row ranges, the
// bucketing's table and the chunks' lists.
size_t carve_backward(char* base, int B, int H, int W, int K, Args* a) {
  const int HW = H * W, R = kChunkRows;
  const size_t slots = (size_t)B * HW * (K / 2);
  const size_t mask = slots * 32 * sizeof(Mask);
  const size_t samples = (size_t)B * HW * K;
  const size_t table = (size_t)B * (((HW + R - 1) / R) *
                                    (((size_t)HW * K + kSegment - 1) / kSegment) + 1);
  const size_t pieces[] = {slots * sizeof(float), mask, mask, samples * sizeof(unsigned),
                           table * sizeof(int), samples * 4 * sizeof(int)};
  size_t off[6], used = 0;
  for (int i = 0; i < 6; ++i) {
    off[i] = used;
    used += align_up(pieces[i]);
  }
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
  const int HW = a.H * a.W, chunks = (HW + kChunkRows - 1) / kChunkRows;
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
