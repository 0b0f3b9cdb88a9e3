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
//   w[q,k]   = softmax_k(scale * masked) [* prior]
//              | softmax over the valid slots (sim != 0) of scale * (sim + prior),
//                0 on the others, 1/K on a row with none  (additive prior)
//              | masked [+ prior] / K                  (softmax off)
//              | prior                                 (similarity 'prior')
//
// The additive prior's softmax is the JAX package's masked form
// (epipolar_transformers_tpu/ops/epipolar_attention.py:
// epipolar_similarity_weights), not softmax(scale * (-1e10 + prior)): that
// one tracks the prior on rows with no valid slot (|prior| > ~512 moves it,
// and its gradient to the prior is not 0 there), where the masked form is
// the constant 1/K.
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
//   dother1[r] = sum over entries (q,k,c) with corner_c = r of ds[q,k] w_c f1[q]
//   dother2[r] = sum over the same entries of w[q,k] w_c dout[q]
//   dprior[k]  = ds[k]              (additive prior, softmax on: 0 where
//                                     sim == 0, and on a row with no valid slot)
//              | g_k / K            (additive prior, softmax off, on every slot:
//                                     (masked + prior) / K is linear in prior)
//              | g_k p_k            (priormul, softmax on)
//              | 0                  (priormul, softmax off: the prior is unused)
//              | g_k                (similarity 'prior')
//   Each (q, k) belongs to one lane, of the tile kernel or of pass A, which
//   writes it: no atomics.
//
// It recomputes the slot data and the similarities with the forward's rules
// instead of reading the forward's weights: the zero-sentinel mask and,
// under priormul with a zero prior, p itself cannot be recovered from w.
//
// What bounds them (reckoned from the shapes): at the flagship shape (B=8,
// 64x64, K=64, C=256, f32) and the synthetic rig's locations the least time
// is set by the operations, 2C flops per distinct live (query, key row)
// pair for each read of that row (~126 pairs a query): 0.063 ms for the
// forward (two reads, at the 67 TFLOP/s of f32 outside the tensor cores)
// and 0.157 ms for the backward (five); their bytes (159 MB and 252 MB at
// 3.35 TB/s) take less.  The per-query kernels instead gather one row per
// live corner, ~209 a query, each for the keys and again for the values,
// ~17 GB per batch in f32 served from L1 and L2: they are bound by gather
// bandwidth, not FLOPs or HBM (the Gram form the forward replaces does ~137
// GFLOP of matmul per batch).
//
// The forward's schedule.  A warp per query (the per-query kernel below)
// loads one row per live corner and uses each loaded float for one FMA: 4
// bytes per FMA, a quarter of f32 peak even from L1.  But every pixel on
// one epipolar line of the reference view maps to the same line here, and
// neighbouring lines of the pencil differ by a fraction of a pixel, so a
// tile of queries grouped by line touches few distinct key rows: at the
// flagship rig ~194 rows for 64 queries, whose live corners make ~10,800
// row loads.  The forward therefore runs three kernels:
//
//   group_kernel: per item, each query's line key (the angle of the segment
//     from its first to its last sample, in HW bins) and a counting sort by
//     it, ties in query order.  An item whose samples do not lie on lines
//     (random locations) is not sorted.  The angle identifies a line only
//     where the epipole is a finite point: a pencil of parallel or nearly
//     parallel lines (an epipole far outside the image, a rectified pair)
//     puts many lines in one bin, interleaved in query order, and their
//     tiles' unions pass kMaxUnion, so those tiles take the per-query kernel.
//     The cap and the rule below were measured on the synthetic rig only.
//   tile_forward_kernel: one CTA per tile of kTileQ consecutive queries of
//     that order.  The union of the tile's live corner rows (a bitmap over
//     the item's rows, compacted in row order); the Gram G_t (queries x up
//     to 256 union slots) from cp.async stages in shared memory, each key
//     row loaded once per tile; sims from G_t's live-corner slots, the
//     weights, depth; N_t[q, slot] = sum_{k,c} w_k w_c in a fixed order;
//     out = N_t V_union.  f32 runs both products on CUDA cores (no TF32), so
//     it differs from the plain version only in summation order; bf16 runs
//     them on tensor cores (mma.sync) with f32 accumulation, its products
//     exact.  A tile of an item without lines, or whose union exceeds
//     kMaxUnion rows, is left: the rule is U <= 256, which every tile at the
//     rig meets (max 224) and none at random locations (~3,700).
//   epipolar_attention_kernel: one warp per query, in query order, for the
//     queries the tile kernel left (all of them where the shape exceeds
//     kMaxTileHW rows an item).
//
// Every run gives the same bits: the sort is stable, each tile sums in a
// fixed order, and which kernel writes a query depends only on the data.
//
// The key and value gradients are the transpose of the queries' gathers: a
// scatter of 2 x 2.1 G adds into corner rows that neighbouring queries
// share.  Done with float atomics it cost ~10 of 12 ms at the flagship shape
// on an H100 and summed in a run-dependent order.  The backward runs the
// forward's grouping and tiles instead, and gathers what the tiles leave,
// with no float atomics and a fixed summation order:
//
//   group_kernel, as the forward: each item's queries in line order.  The
//     backward recomputes it (~0.03 ms at the flagship) rather than keep
//     the forward's order, so that EpipolarAttentionFn keeps its inputs
//     only.
//   tile_backward_kernel: one CTA of 16 warps per tile of kTileQ queries of
//     that order.
//     (a) the union of the tile's live corner rows, as the forward forms it;
//     (b) Gd_t = dOut_t V_U^T and each query's g from its live-corner
//     slots; (c) G_t = F1_t K_U^T; (d) one warp per query: the sims from
//     G_t, then w, ds and dprior by pass A's rules (logit_grads), and
//     D_t[q, slot] = sum_{k,c} ds_k w_c in place of G_t's row, in the fixed
//     order the forward forms N_t in; (e) dfeat1 = D_t K_U, each query's row
//     written once; (f) the keys' partial D_t^T F1_t; (g) N_t[q, slot] =
//     sum_{k,c} w_k w_c in place of D_t and the values' partial N_t^T
//     dOut_t, added to the keys' by the thread that wrote them when keys and
//     values are one tensor.  Five products of 2 C kTileQ U flops a tile,
//     each key row loaded once a product.  Every product runs on CUDA cores
//     in f32: f32 differs from the plain version only in summation order
//     (no TF32); bf16 rows are converted to f32 as they are staged, so its
//     products are exact and dout, D and N are never rounded (tensor cores
//     would round dout, D and N to bf16).  f32 key rows are staged with
//     cp.async (two stages of kBwdCW features for the Gram products, of
//     kBwdKeyRows rows for dfeat1), bf16 through registers.  The union cap
//     is the backward's own, kBwdUnion = 320 rows (the caller may lower it
//     per launch): G_t, D_t and N_t take 64 x 324 floats, and shared memory
//     (BwdShape, ~168 KB at K=64, C=256) holds one CTA on an SM; every tile
//     of the 64x64 rig (max union 224) and of the 96x96 rig (max 297, where
//     the forward's 256 holds 19%) fits.  A tile above the cap, or of an
//     item without lines, is left to the passes below, counted by tiles.
//     The partials go to scratch at the tile's place, kBwdUnion rows a
//     tile (a tile writes its U), with the union's bitmap and prefix.
//   A (query_backward_kernel): one warp per query the tile kernel left, as
//     the forward's per-query kernel: the sims, g, w, ds, and dfeat1 in
//     registers; writes ds and w (B, HW, K).
//   B (tile_histogram_kernel, tile_scan_kernel, row_offset_kernel,
//     fill_kernel): a CSR map from each key row r to the entries (q, k, c)
//     of the queries pass A took, kept only where w_c != 0 (a zero-weight
//     corner may lie off the image).  Queries are cut into tiles of kTile;
//     a tile with no such query is skipped by all three; the entries of
//     each other (tile, row) are counted in shared memory, scanned over
//     tiles and then over rows, and one warp per tile fills its entries in
//     query order, ranking equal rows within a warp step with
//     __match_any_sync.  The order of a row's entries is therefore fixed:
//     by tile, query, and step within the query.  Each entry is one int,
//     (q, k, c) packed: 34 MB at the flagship shape when every query is
//     left, which fits L2 (three 4-byte arrays, 100 MB, made the fill ~6x
//     slower on an H100).
//   C (row_gather_kernel, row_fixup_kernel): one warp per chunk of kChunk
//     entries, so a row near an epipole that collects entries from most
//     queries is spread over many warps.  Each lane decodes one entry and
//     forms its coefficients ds w_c and w w_c from ds, w and the slot data,
//     as the fill formed w_c; entries of a row that repeat a query (27% at
//     the flagship rig) are summed first.  The warp gathers f1[q] and
//     dout[q] rows with kUnroll entries' rows in flight per lane (registers,
//     not a cp.async ring: the rows are reused from L1/L2 and need no
//     staging), sums them in f32 registers and writes each row that lies
//     inside its chunk once.
//     A row that crosses chunks leaves one partial sum per chunk (at most two
//     per chunk, its first and its last row); a warp per such row adds them
//     in chunk order.  Without the tile schedule empty rows are written as
//     zeros there too, so no output is filled beforehand.  When the keys and
//     the values are one tensor, dother1 + dother2 is summed into one buffer.
//   tile_reduce_kernel: one warp per key row: the partials of the tiles
//     whose union holds it (found from their bitmaps), in tile order, then
//     pass C's sum added; an empty row is written here.
//
// At the flagship shape on an H100 (f32, keys = values, the synthetic rig's
// locations) the three-pass backward took ~2.95 ms (A ~1.65, B ~0.28, C
// ~0.99 ms) against a bound of ~0.16 ms; PERF.md has the tile schedule's
// times.  Items whose samples are random (edge-crossing) take passes A-C
// as before, and the grouping, the empty tile kernel and the reduction
// cost ~0.08 ms more there.
//
// Two runs on the same inputs give bit-equal gradients: the grouping is
// stable, each tile sums in a fixed order, which path takes a tile depends
// only on the data, and the reduction adds in tile order.
//
// Scratch (the query order and flags of both; the backward's tile partials,
// counts, CSR, entries, partials) comes from the caller, sized by
// epipolar_attention_forward_scratch_bytes and
// epipolar_attention_backward_scratch_bytes.
//
// Shape of the per-query kernels: one warp per query pixel.  Lane l holds
// channels [l*NV, l*NV + NV) of the C = 32*NV channels.  Lane l also owns
// samples k = l + 32*i and computes their slot data with exactly the rules
// of quad_gather._axis_slot_weights; the warp walks the samples,
// broadcasting each sample's slot data with shuffles, and reduces each dot
// product with a butterfly.  The masked softmax over K runs inside the warp
// (each lane holds K/32 values).  A second sweep accumulates `out`
// (forward) or `dfeat1` (backward) in f32 registers.
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
constexpr int kTile = 32;          // queries per tile of the CSR fill
constexpr int kChunk = 512;        // entries per warp of the row gather
constexpr int kUnroll = 4;         // entries whose rows a lane loads at once
constexpr int kScanThreads = 1024;
// the fill keeps one cursor per key row of an item in shared memory
constexpr int kMaxKeyRows = 227 * 1024 / 4;
// the forward's tile schedule
constexpr int kTileQ = 64;         // queries per tile (32 measured slower on an H100)
constexpr int kMaxUnion = 256;     // key rows a tile may stage: 8 groups of 32
constexpr int kMaxTileHW = 16384;  // key rows of an item the tile path takes
constexpr int kTileThreads = 256;  // 8 warps; warp w owns kTileQ / 8 queries
constexpr int kRowsPerWarp = kTileQ / 8;
constexpr int kValueRows = 16;     // value rows per stage of out = N V
constexpr int kGroupThreads = 1024;

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

// 128 bytes: with one more pointer here (136) the per-query forward kernel
// ran ~6% slower on an H100 (1.4497 against 1.3672 ms at edge-crossing
// locations), so flags a kernel alone needs are passed beside it.
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
  float* ds;           // backward: (B, HW, K) logit gradients, or null
  float* w;            // backward: (B, HW, K) attention weights, or null
  float* dprior;       // backward: (B, K, HW) gradient of the prior, or null
  int B, H, W, K;
  float scale;
  int use_sim;   // similarity != 'prior'
  int softmax;   // softmax enabled
  int priormul;  // multiply the prior after the softmax
};

// The forward's tile schedule, in the caller's scratch.
struct Schedule {
  int* tile_counts;     // [tiles on the tile path, on the per-query path]
  int* item_lines;      // (B) 1 where the item's samples lie on lines
  int* perm;            // (B, HW) each item's queries in line order
  unsigned char* done;  // (B, HW) 1 where the tile path wrote the query
};

// The transpose of the backward: the CSR map from key rows to entries, and
// the key/value gradients it produces.  Rows are numbered g = b * HW + r.
struct Transpose {
  const unsigned char* done;  // (B, HW) 1 where the tile path took the query, or null
  int tiles;        // query tiles per item
  int* tile_live;   // (B, tiles) 1 where the tile holds a query the tile path
                    // left; the others' tile_rows are neither written nor read
  int* tile_rows;   // (B, tiles, HW): entries of (tile, row), then their
                    // exclusive prefix over the item's tiles
  int* row_ptr;     // (B * HW + 1) entry offsets of the rows
  int* block_total; // entries of each block of kScanThreads rows
  int* entry;       // (b * HW + q) << 9 | k << 2 | c, in row order
  float* part1;     // (chunks, 2, C) partial row sums of dother1
  float* part2;     // (chunks, 2, C) partial row sums of dother2, or null
  float* d1;        // (B * HW, C) dother1 (dother1 + dother2 when fused)
  float* d2;        // (B * HW, C) dother2, or null
  int reduced;      // the row reduction follows and writes the empty rows
};

// Slot data of sample k of query q: the base corner and the per-axis weights.
__device__ __forceinline__ void sample_slot(const Params& p, int b, int q,
                                            int k, int& base, float& wx0,
                                            float& wx1, float& wy0,
                                            float& wy1) {
  const int HW = p.H * p.W;
  const float* l = p.locs + (((size_t)b * p.K + k) * HW + q) * 2;
  // align_corners=True unnormalize, as the JAX wrapper computes it
  const float x = (l[0] + 1.0f) / 2.0f * (float)(p.W - 1);
  const float y = (l[1] + 1.0f) / 2.0f * (float)(p.H - 1);
  int xb, yb;
  axis_slot_weights(x, p.W, xb, wx0, wx1);
  axis_slot_weights(y, p.H, yb, wy0, wy1);
  base = yb * p.W + xb;
}

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
      sample_slot(p, b, q, k, s.base[i], s.wx0[i], s.wx1[i], s.wy0[i], s.wy1[i]);
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
// on) the softmax p before the prior multiply.  With an additive prior the
// softmax runs over the valid slots (s != 0) only, and a row without one
// is uniform (the JAX package's masked form).
__device__ __forceinline__ void attention_weights(
    const Params& p, const Slots& sl, int lane, const float (&s)[kMaxSlotsPerLane],
    float (&prob)[kMaxSlotsPerLane], float (&w)[kMaxSlotsPerLane]) {
  const bool additive = p.prior != nullptr && !p.priormul;
  const bool masked_softmax = additive && p.softmax;
  float logit[kMaxSlotsPerLane];
  bool live[kMaxSlotsPerLane];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) {
    const bool valid = lane + 32 * i < p.K;
    float m = (s[i] == 0.f) ? kNegInf : s[i];
    if (additive) m = m + sl.pr[i];
    // the masked softmax keeps the valid slots only
    live[i] = valid && (!masked_softmax || s[i] != 0.f);
    if (p.softmax) {
      logit[i] = live[i] ? m * p.scale : -INFINITY;
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
      e[i] = live[i] ? expf(logit[i] - mx) : 0.f;
      sum += e[i];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      // a row with no valid slot (masked softmax only: otherwise every
      // slot k < K is live) is uniform over the K slots
      prob[i] = sum > 0.f ? e[i] / sum : (lane + 32 * i < p.K ? 1.f / (float)p.K : 0.f);
      w[i] = prob[i];
      if (p.prior != nullptr && p.priormul) w[i] = w[i] * sl.pr[i];
    }
  }
}

// Blocks of 8 warps per SM: bf16 is held to 4 (64 registers; at the 80 that
// ptxas otherwise picks, 3 blocks fit and it ran ~6% slower on an H100), f32
// to 3 (80 registers, as ptxas picks without a bound)
template <typename T, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, sizeof(T) == 2 ? 4 : 3)
epipolar_attention_kernel(const Params p, const unsigned char* done) {
  const int lane = threadIdx.x & 31;
  const int HW = p.H * p.W;
  const long long gq =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gq >= (long long)p.B * HW) return;  // uniform across the warp
  if (done != nullptr && done[gq]) return;  // the tile path wrote it
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

// ---- forward, tile path: grouping ----------------------------------------

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The four corners of sample k of query q: key rows and weights, zero for a
// corner off the image.  The weights are the products broadcast_corners
// forms, so every kernel agrees on every zero.
struct SampleCorners {
  int row[4];
  float wc[4];
};

__device__ __forceinline__ SampleCorners sample_corners(const Params& p, int b,
                                                        int q, int k) {
  SampleCorners s;
  int base = 0;
  float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;
  if (k < p.K) sample_slot(p, b, q, k, base, x0, x1, y0, y1);
  s.row[0] = base;
  s.row[1] = base + 1;
  s.row[2] = base + p.W;
  s.row[3] = base + p.W + 1;
  s.wc[0] = y0 * x0;
  s.wc[1] = y0 * x1;
  s.wc[2] = y1 * x0;
  s.wc[3] = y1 * x1;
  return s;
}

constexpr double kPi = 3.141592653589793;

// The line key of query q: the angle in [0, pi) of the segment from its
// first to its last sample, in HW bins.  A line without extent (it misses
// the image, so every sample sits at the far sentinel; or K == 1) takes bin
// HW.  _line_bins in ops/epipolar_attention_cuda.py computes the same.
__device__ __forceinline__ int line_bin(const Params& p, int b, int q) {
  const int HW = p.H * p.W;
  const float* first = p.locs + ((size_t)b * p.K * HW + q) * 2;
  const float* last = p.locs + (((size_t)b * p.K + p.K - 1) * HW + q) * 2;
  const float dx = __fsub_rn((last[0] + 1.0f) / 2.0f * (float)(p.W - 1),
                             (first[0] + 1.0f) / 2.0f * (float)(p.W - 1));
  const float dy = __fsub_rn((last[1] + 1.0f) / 2.0f * (float)(p.H - 1),
                             (first[1] + 1.0f) / 2.0f * (float)(p.H - 1));
  if (dx == 0.f && dy == 0.f) return HW;
  float a = atan2f(dy, dx);
  if (a < 0.f) a += (float)kPi;
  return min(max((int)(a * (float)((double)HW / kPi)), 0), HW - 1);
}

// Whether the samples of query q lie on the segment from its first to its
// last (as epipolar_sample_locs spaces them): the middle sample within half
// a pixel of its place on that segment.
__device__ __forceinline__ bool on_line(const Params& p, int b, int q) {
  if (p.K < 3) return true;
  const int HW = p.H * p.W, mid = p.K / 2;
  const float* l = p.locs + ((size_t)b * p.K * HW + q) * 2;
  const size_t step = (size_t)HW * 2;
  const float sx = 0.5f * (float)(p.W - 1), sy = 0.5f * (float)(p.H - 1);
  const float t = (float)mid / (float)(p.K - 1);
  const float x0 = l[0] * sx, y0 = l[1] * sy;
  const float x1 = l[(p.K - 1) * step] * sx, y1 = l[(p.K - 1) * step + 1] * sy;
  const float xm = l[mid * step] * sx, ym = l[mid * step + 1] * sy;
  return fabsf(x0 + (x1 - x0) * t - xm) <= 0.5f && fabsf(y0 + (y1 - y0) * t - ym) <= 0.5f;
}

// One block per item: each query's line key, a counting sort by key (the
// histogram in shared memory, a block scan), and a fill by one warp in
// query order, ranking equal keys within a step with __match_any_sync, so
// ties keep query order and the order is the same on every run.  An item
// with fewer than half its queries' samples on lines (random locations)
// has no lines to group by: it is not sorted, and the tile kernel leaves
// all its tiles to the per-query kernel.
__global__ void __launch_bounds__(kGroupThreads) group_kernel(const Params p,
                                                               const Schedule sch) {
  extern __shared__ int group_smem[];
  __shared__ int warp_total[kGroupThreads / 32];
  __shared__ int lines;
  const int HW = p.H * p.W, bins = HW + 1;
  int* key = group_smem;          // HW
  int* cursor = group_smem + HW;  // bins
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (b == 0 && threadIdx.x < 2) sch.tile_counts[threadIdx.x] = 0;
  if (threadIdx.x == 0) lines = 0;
  for (int r = threadIdx.x; r < bins; r += kGroupThreads) cursor[r] = 0;
  __syncthreads();
  int mine = 0;
  for (int q = threadIdx.x; q < HW; q += kGroupThreads) {
    key[q] = line_bin(p, b, q);
    mine += on_line(p, b, q);
    sch.done[(size_t)b * HW + q] = 0;
  }
  atomicAdd(&lines, mine);
  __syncthreads();
  const bool grouped = 2 * lines >= HW;
  if (threadIdx.x == 0) sch.item_lines[b] = grouped;
  if (!grouped) return;  // uniform across the block
  for (int q = threadIdx.x; q < HW; q += kGroupThreads) atomicAdd(&cursor[key[q]], 1);
  __syncthreads();
  // exclusive scan of the bin counts: a contiguous segment per thread
  const int seg = (bins + kGroupThreads - 1) / kGroupThreads;
  const int r0 = min((int)threadIdx.x * seg, bins), r1 = min(r0 + seg, bins);
  int sum = 0;
  for (int r = r0; r < r1; ++r) sum += cursor[r];
  const int incl = warp_inclusive_scan(sum, lane);
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) warp_total[lane] = warp_inclusive_scan(warp_total[lane], lane);
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int r = r0; r < r1; ++r) {
    const int c = cursor[r];
    cursor[r] = run;
    run += c;
  }
  __syncthreads();
  if (warp != 0) return;
  const unsigned lower = (1u << lane) - 1u;
  int* perm = sch.perm + (size_t)b * HW;
  for (int base = 0; base < HW; base += 32) {
    const int q = base + lane;
    const int k = q < HW ? key[q] : -1;
    const unsigned peers = __match_any_sync(kFull, k);
    int pos = 0;
    if (q < HW) pos = cursor[k] + __popc(peers & lower);
    __syncwarp();
    if (q < HW && (peers & lower) == 0u) cursor[k] += __popc(peers);
    __syncwarp();
    if (q < HW) perm[pos] = q;
  }
}

// ---- forward, tile path: one CTA per tile of kTileQ queries ---------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bf16 tensor cores: D += A B with A 16x16 (row-major), B 16x8 (col-major),
// bf16 operands, f32 accumulation (PTX ISA, mma.m16n8k16 fragments: lane
// l = 4 g + t holds A rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t +
// 9; B rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; D rows g and g + 8,
// columns 2t, 2t + 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The B fragment of rows [k0, k0 + 16) x columns [n0, n0 + 8) of a
// row-major bf16 matrix in shared memory (lanes 0-15 address its rows).
__device__ __forceinline__ void ldmatrix_b_trans(const void* row, unsigned& b0,
                                                 unsigned& b1) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a));
}

// Two f32 as a bf16 pair, rounded to nearest (x in the low half), and what
// the rounding left: x = hi + lo to ~16 bits.
__device__ __forceinline__ unsigned bf16_pair(float x, float y, float& rx, float& ry) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  rx = x - f.x;
  ry = y - f.y;
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ unsigned bf16_pair(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The slot of key row `row` in the tile's union (rows in row order).
__device__ __forceinline__ int union_slot(const unsigned* bits, const int* prefix,
                                          int row) {
  const int w = row >> 5;
  return prefix[w] + __popc(bits[w] & ((1u << (row & 31)) - 1u));
}

// (a) of both tile kernels: the tile's queries (qidx) from the grouping's
// order, and the union of their live corner rows, as a bitmap over the
// item's key rows with the exclusive prefix of its words' populations.
// Returns the union's size on every thread of the CTA (kThreads of them).
template <int kThreads>
__device__ __forceinline__ int tile_union(const Params& p, const Schedule& sch, int b, int tile,
                                          int* qidx, unsigned* bits, int* prefix, int* nunion) {
  const int HW = p.H * p.W, HWW = (HW + 31) / 32, K = p.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(kTileQ, HW - tile * kTileQ);
  if (tid < nq) qidx[tid] = sch.perm[(size_t)b * HW + tile * kTileQ + tid];
  for (int i = tid; i < HWW; i += kThreads) bits[i] = 0u;
  __syncthreads();
  for (int e = tid; e < kTileQ * K; e += kThreads) {
    const int r = e % kTileQ, k = e / kTileQ;
    if (r >= nq) continue;
    const SampleCorners s = sample_corners(p, b, qidx[r], k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (s.wc[c] != 0.f) atomicOr(&bits[s.row[c] >> 5], 1u << (s.row[c] & 31));
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the words' populations
    const int per = (HWW + 31) / 32;
    const int w0 = min(lane * per, HWW), w1 = min(w0 + per, HWW);
    int sum = 0;
    for (int i = w0; i < w1; ++i) sum += __popc(bits[i]);
    const int incl = warp_inclusive_scan(sum, lane);
    int run = incl - sum;
    for (int i = w0; i < w1; ++i) {
      prefix[i] = run;
      run += __popc(bits[i]);
    }
    if (lane == 31) *nunion = incl;
  }
  __syncthreads();
  return *nunion;
}

// The union's rows of bitmap word i, in row order, at their slots.
__device__ __forceinline__ void compact_word(const unsigned* bits, const int* prefix, int* rows,
                                             int i) {
  int s = prefix[i];
  for (unsigned m = bits[i]; m != 0u; m &= m - 1u) rows[s++] = i * 32 + __ffs(m) - 1;
}

// sum_c w_c row[slot(corner_c)] of a lane's sample group j, over its live
// corners only (a sample without one stays exactly 0): a tile's similarity
// (row = G's) or g (row = Gd's).
__device__ __forceinline__ float corner_sum(const float* row, const Slots& sl, int j,
                                            const unsigned* bits, const int* prefix, int W) {
  const float c00 = sl.wy0[j] * sl.wx0[j], c01 = sl.wy0[j] * sl.wx1[j];
  const float c10 = sl.wy1[j] * sl.wx0[j], c11 = sl.wy1[j] * sl.wx1[j];
  const int r0 = sl.base[j];
  float acc = 0.f;
  if (c00 != 0.f) acc += c00 * row[union_slot(bits, prefix, r0)];
  if (c01 != 0.f) acc += c01 * row[union_slot(bits, prefix, r0 + 1)];
  if (c10 != 0.f) acc += c10 * row[union_slot(bits, prefix, r0 + W)];
  if (c11 != 0.f) acc += c11 * row[union_slot(bits, prefix, r0 + W + 1)];
  return acc;
}

// row[slot] = sum over the query's live corners (k, c) at that slot of
// coef_k w_c, after zeroing the row's first upad entries; in a fixed order
// (sample group, corner, lane: equal slots within a step are ranked with
// __match_any_sync and added by their first lane): a tile's N (coef = w)
// or D (coef = ds).
__device__ __forceinline__ void scatter_row(float* row, const Slots& sl,
                                            const float (&coef)[kMaxSlotsPerLane],
                                            const unsigned* bits, const int* prefix, int upad,
                                            int W, int K, int lane, float* sc) {
  const unsigned lower = (1u << lane) - 1u;
  __syncwarp();
  for (int u = lane; u < upad; u += 32) row[u] = 0.f;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kMaxSlotsPerLane; ++j) {
    if (32 * j >= K) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float wc = ((c & 2) ? sl.wy1[j] : sl.wy0[j]) * ((c & 1) ? sl.wx1[j] : sl.wx0[j]);
      const bool live = lane + 32 * j < K && wc != 0.f;
      const unsigned mask = __ballot_sync(kFull, live);
      if (mask == 0u) continue;  // uniform across the warp
      unsigned peers = 0u;
      int slot = 0;
      if (live) {
        slot = union_slot(bits, prefix, sl.base[j] + ((c & 2) ? W : 0) + (c & 1));
        peers = __match_any_sync(mask, slot);
      }
      sc[lane] = coef[j] * wc;
      __syncwarp();
      if (live && (peers & lower) == 0u) {
        float sum = row[slot];
        for (unsigned m = peers; m != 0u; m &= m - 1u) sum += sc[__ffs(m) - 1];
        row[slot] = sum;
      }
      __syncwarp();
    }
  }
}

// Shared memory of the tile kernel, in 4-byte words.  The big region holds
// either the two stages of the Gram product (the tile's query rows and the
// union's key rows, CW words of each per stage), or G (then N, in place)
// and two stages of kValueRows value rows.  Rows are padded so that the
// lanes of a warp hit distinct banks: f32 reads one word of 32 rows (CW + 1
// words a row); bf16 reads mma fragments, one word of 8 rows x 4 (CW + 4)
// and value rows through ldmatrix, 16 bytes of 8 rows (WR + 4).
template <typename T, int NV>
struct TileShape {
  static constexpr bool kMma = sizeof(T) == 2;   // bf16 on tensor cores
  static constexpr int E = 4 / (int)sizeof(T);  // features per word
  static constexpr int WR = 32 * NV / E;        // words per feature row
  static constexpr int CW = WR < 32 ? WR : 32;  // words per stage of G
  static constexpr int GS = kMaxUnion + 1;      // row stride of G and N
  static constexpr int QKS = CW + (kMma ? 4 : 1);  // row stride of a G stage
  static constexpr int VS = WR + (kMma ? 4 : 0);   // row stride of a value stage
  static constexpr int kStage = (kTileQ + kMaxUnion) * QKS;
  static constexpr int kGram = 2 * kStage;
  static constexpr int kOut = kTileQ * GS + 2 * kValueRows * VS;
  static constexpr int kBig = ((kGram > kOut ? kGram : kOut) + 3) / 4 * 4;
  static size_t bytes(int HW) {  // big region, bitmap, prefix, rows, queries, scratch
    return (size_t)(kBig + 2 * ((HW + 31) / 32) + kMaxUnion + kTileQ + kTileThreads + 1) * 4;
  }
};

// (c) on CUDA cores (f32): G = F1_tile F2k_union^T over the union's first
// 32 NG columns, each warp holding kRowsPerWarp query rows x NG columns
// (lane + 32 n) in registers; stage_g(chunk, buf) stages CW words of every
// row.
template <int NV, int NG, typename Stage>
__device__ __forceinline__ void gram_fma(const unsigned* stages, Stage stage_g, float* G,
                                         int warp, int lane) {
  using S = TileShape<float, NV>;
  constexpr int CW = S::CW, QKS = S::QKS, kChunks = S::WR / CW;
  float acc[kRowsPerWarp][NG];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int n = 0; n < NG; ++n) acc[i][n] = 0.f;
  stage_g(0, 0);
  for (int chunk = 0; chunk < kChunks; ++chunk) {
    if (chunk + 1 < kChunks) {
      stage_g(chunk + 1, (chunk + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = reinterpret_cast<const float*>(stages + (chunk & 1) * S::kStage);
    const float* qs = st + warp * kRowsPerWarp * QKS;
    const float* ks = st + (kTileQ + lane) * QKS;
#pragma unroll 4
    for (int w = 0; w < CW; ++w) {
      float qv[kRowsPerWarp], kv[NG];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) qv[i] = qs[i * QKS + w];
#pragma unroll
      for (int n = 0; n < NG; ++n) kv[n] = ks[n * 32 * QKS + w];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int n = 0; n < NG; ++n) acc[i][n] = fmaf(qv[i], kv[n], acc[i][n]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int n = 0; n < NG; ++n) G[(warp * kRowsPerWarp + i) * S::GS + lane + 32 * n] = acc[i][n];
}

// (c) on tensor cores (bf16): warp w takes query rows 16 (w % kMBlocks) and
// kNT column tiles of 8 from 8 kNT (w / kMBlocks); tiles past the union
// are skipped.  G's rows are shared by several warps, so the block syncs.
template <int NV, typename Stage>
__device__ __forceinline__ void gram_mma(const unsigned* stages, Stage stage_g, float* G,
                                         int U, int warp, int lane) {
  using S = TileShape<__nv_bfloat16, NV>;
  constexpr int CW = S::CW, QKS = S::QKS, kChunks = S::WR / CW;
  constexpr int kMBlocks = kTileQ / 16, kNT = 4 * kMBlocks;  // 256 columns / (8 / kMBlocks) warps
  const int m0 = 16 * (warp % kMBlocks), n0 = 8 * kNT * (warp / kMBlocks);
  const int g = lane >> 2, t = lane & 3;
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  stage_g(0, 0);
  for (int chunk = 0; chunk < kChunks; ++chunk) {
    if (chunk + 1 < kChunks) {
      stage_g(chunk + 1, (chunk + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned* st = stages + (chunk & 1) * S::kStage;
    const unsigned* qs = st + (m0 + g) * QKS + t;
#pragma unroll
    for (int kw = 0; kw < CW; kw += 8) {  // 16 features a step
      const unsigned a0 = qs[kw], a1 = qs[8 * QKS + kw];
      const unsigned a2 = qs[kw + 4], a3 = qs[8 * QKS + kw + 4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (n0 + 8 * j >= U) break;  // uniform across the warp
        const unsigned* ks = st + (kTileQ + n0 + 8 * j + g) * QKS + t + kw;
        mma_bf16(acc[j], a0, a1, a2, a3, ks[0], ks[4]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    float* row = G + (m0 + g) * S::GS + n0 + 8 * j + 2 * t;
    row[0] = acc[j][0];
    row[1] = acc[j][1];
    row[8 * S::GS] = acc[j][2];
    row[8 * S::GS + 1] = acc[j][3];
  }
  __syncthreads();
}

// (e) on CUDA cores (f32): out = N V_union, each warp holding
// kRowsPerWarp query rows x NV channels (lane + 32 n) in registers.
template <int NV, typename Stage>
__device__ __forceinline__ void out_fma(const unsigned* vstages, Stage stage_v, int vchunks,
                                        const float* G, const int* qidx, int nq,
                                        float* out, int warp, int lane) {
  using S = TileShape<float, NV>;
  constexpr int C = 32 * NV;
  float acc[kRowsPerWarp][NV];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int n = 0; n < NV; ++n) acc[i][n] = 0.f;
  for (int chunk = 0; chunk < vchunks; ++chunk) {
    if (chunk + 1 < vchunks) {
      stage_v(chunk + 1, (chunk + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* vs = reinterpret_cast<const float*>(vstages + (chunk & 1) * kValueRows * S::VS);
    const float* nrow = G + warp * kRowsPerWarp * S::GS + chunk * kValueRows;
#pragma unroll 4
    for (int r = 0; r < kValueRows; ++r) {
      float nv[kRowsPerWarp], v[NV];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) nv[i] = nrow[i * S::GS + r];
#pragma unroll
      for (int n = 0; n < NV; ++n) v[n] = vs[r * S::VS + lane + 32 * n];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int n = 0; n < NV; ++n) acc[i][n] = fmaf(nv[i], v[n], acc[i][n]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r >= nq) break;
    float* o = out + (size_t)qidx[r] * C + lane;
#pragma unroll
    for (int n = 0; n < NV; ++n) o[32 * n] = acc[i][n];
  }
}

// (e) on tensor cores (bf16 values): warp w takes query rows 16 (w %
// kMBlocks) and kNT column tiles of 8 from 8 kNT (w / kMBlocks).  N is f32:
// it enters as hi + lo, two bf16 products, so out keeps ~16 bits of N where
// one bf16 operand would keep 8.
template <int NV, typename Stage>
__device__ __forceinline__ void out_mma(const unsigned* vstages, Stage stage_v, int vchunks,
                                        const float* G, const int* qidx, int nq,
                                        float* out, int warp, int lane) {
  using S = TileShape<__nv_bfloat16, NV>;
  constexpr int C = 32 * NV, kMBlocks = kTileQ / 16, kNT = C * kMBlocks / 64;
  const int m0 = 16 * (warp % kMBlocks), n0 = 8 * kNT * (warp / kMBlocks);
  const int g = lane >> 2, t = lane & 3;
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int chunk = 0; chunk < vchunks; ++chunk) {
    if (chunk + 1 < vchunks) {
      stage_v(chunk + 1, (chunk + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned* vs = vstages + (chunk & 1) * kValueRows * S::VS;
    const float* top = G + (m0 + g) * S::GS + chunk * kValueRows + 2 * t;  // row g
    const float* bot = top + 8 * S::GS;                                     // row g + 8
    float r0, r1, r2, r3, r4, r5, r6, r7;
    const unsigned a0 = bf16_pair(top[0], top[1], r0, r1);
    const unsigned a1 = bf16_pair(bot[0], bot[1], r2, r3);
    const unsigned a2 = bf16_pair(top[8], top[9], r4, r5);
    const unsigned a3 = bf16_pair(bot[8], bot[9], r6, r7);
    const unsigned l0 = bf16_pair(r0, r1), l1 = bf16_pair(r2, r3);
    const unsigned l2 = bf16_pair(r4, r5), l3 = bf16_pair(r6, r7);
    // lanes 0-15 address the 16 value rows of the chunk
    const unsigned* vrow = vs + (lane & 15) * S::VS + n0 / 2;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      unsigned b0, b1;
      ldmatrix_b_trans(vrow + 4 * j, b0, b1);
      mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[j], l0, l1, l2, l3, b0, b1);
    }
    __syncthreads();
  }
  const int ra = m0 + g, rb = m0 + g + 8;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (ra < nq)
      *reinterpret_cast<float2*>(out + (size_t)qidx[ra] * C + col) = make_float2(acc[j][0], acc[j][1]);
    if (rb < nq)
      *reinterpret_cast<float2*>(out + (size_t)qidx[rb] * C + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

// (a) the union of the tile's live corner rows, as a bitmap over the item's
// key rows compacted in row order; a tile whose union exceeds kMaxUnion is
// left to the per-query kernel.  (b, c) G = F1_tile F2k_union^T (kTileQ x
// up to 256) from cp.async stages of CW words (gram_fma, gram_mma).  (d)
// one warp per query: sims from G's live-corner slots, the weights as the
// per-query kernel forms them, depth, and N's row in place of G's, summed
// in a fixed order (sample group, corner, lane: equal slots within a step
// are ranked with __match_any_sync and added by their first lane); the
// next query's slot data loads meanwhile.  (e) out = N V_union from
// cp.async stages of kValueRows rows (out_fma, out_mma).  Shared memory
// (TileShape) holds two CTAs on an SM.
template <typename T, int NV>
__global__ void __launch_bounds__(kTileThreads, 2)
tile_forward_kernel(const Params p, const Schedule sch) {
  using S = TileShape<T, NV>;
  constexpr int WR = S::WR, CW = S::CW, GS = S::GS;
  constexpr int C = 32 * NV;
  const int HW = p.H * p.W, HWW = (HW + 31) / 32, K = p.K, W = p.W;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(kTileQ, HW - tile * kTileQ);
  const size_t item = (size_t)b * HW;
  if (!sch.item_lines[b]) {  // uniform: no lines to group by
    if (tid == 0) atomicAdd(&sch.tile_counts[1], 1);
    return;
  }

  extern __shared__ __align__(16) unsigned char tile_smem[];
  float* big = reinterpret_cast<float*>(tile_smem);
  unsigned* bits = reinterpret_cast<unsigned*>(big + S::kBig);
  int* prefix = reinterpret_cast<int*>(bits + HWW);
  int* rows = prefix + HWW;
  int* qidx = rows + kMaxUnion;
  float* scratch = reinterpret_cast<float*>(qidx + kTileQ);
  int* nunion = reinterpret_cast<int*>(scratch + kTileThreads);

  // (a)
  const int U = tile_union<kTileThreads>(p, sch, b, tile, qidx, bits, prefix, nunion);
  if (U > kMaxUnion) {  // uniform across the block
    if (tid == 0) atomicAdd(&sch.tile_counts[1], 1);
    return;
  }
  if (tid == 0) atomicAdd(&sch.tile_counts[0], 1);
  if (tid < nq) sch.done[item + qidx[tid]] = 1;
  for (int i = tid; i < HWW; i += kTileThreads) compact_word(bits, prefix, rows, i);
  __syncthreads();

  const unsigned* f1w = static_cast<const unsigned*>(p.f1);
  const unsigned* f2kw = static_cast<const unsigned*>(p.f2k);
  const unsigned* f2vw = static_cast<const unsigned*>(p.f2v);
  unsigned* stages = reinterpret_cast<unsigned*>(big);
  float* G = big;  // (kTileQ, GS): G, then N in place
  unsigned* vstages = reinterpret_cast<unsigned*>(big + kTileQ * GS);
  const int upad = (U + kValueRows - 1) / kValueRows * kValueRows;

  // (b, c)
  if (p.use_sim && U > 0) {  // uniform across the block
    auto stage_g = [&](int chunk, int buf) {
      unsigned* dst = stages + buf * S::kStage;
      for (int e = tid; e < (kTileQ + U) * CW; e += kTileThreads) {
        const int r = e / CW, w = e - r * CW;
        const unsigned* src;
        if (r < kTileQ) {
          if (r >= nq) continue;
          src = f1w + (item + qidx[r]) * WR;
        } else {
          src = f2kw + (item + rows[r - kTileQ]) * WR;
        }
        cp_async4(dst + r * S::QKS + w, src + chunk * CW + w);
      }
      cp_async_commit();
    };
    if constexpr (S::kMma) {
      gram_mma<NV>(stages, stage_g, G, U, warp, lane);
    } else {  // the 32-column groups the union needs; at the rig U <= 224
      if (U <= 192)
        gram_fma<NV, 6>(stages, stage_g, G, warp, lane);
      else if (U <= 224)
        gram_fma<NV, 7>(stages, stage_g, G, warp, lane);
      else
        gram_fma<NV, 8>(stages, stage_g, G, warp, lane);
    }
  }

  // the first value rows load while the weights are formed
  auto stage_v = [&](int chunk, int buf) {
    unsigned* dst = vstages + buf * kValueRows * S::VS;
    for (int e = tid; e < kValueRows * (WR / 4); e += kTileThreads) {
      const int r = e / (WR / 4), w = 4 * (e - r * (WR / 4));
      const int u = chunk * kValueRows + r;
      if (u < U)
        cp_async16(dst + r * S::VS + w, f2vw + (item + rows[u]) * WR + w);
      else
        *reinterpret_cast<uint4*>(dst + r * S::VS + w) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  };
  const int vchunks = upad / kValueRows;
  if (vchunks > 0) stage_v(0, 0);

  // (d)
  float* sc = scratch + warp * 32;
  const int first = warp * kRowsPerWarp;
  Slots next;  // the next query's slot data loads while this one's is used
  if (first < nq) load_slots(p, b, qidx[first], lane, next);
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = first + i;
    if (r >= nq) break;  // uniform across the warp
    const int q = qidx[r];
    float* g = G + r * GS;
    const Slots sl = next;
    if (i + 1 < kRowsPerWarp && r + 1 < nq) load_slots(p, b, qidx[r + 1], lane, next);
    float w[kMaxSlotsPerLane];
    if (p.use_sim) {
      float s[kMaxSlotsPerLane];  // the weights of k >= K are all 0
#pragma unroll
      for (int j = 0; j < kMaxSlotsPerLane; ++j) s[j] = corner_sum(g, sl, j, bits, prefix, W);
      float prob[kMaxSlotsPerLane];
      attention_weights(p, sl, lane, s, prob, w);
    } else {
#pragma unroll
      for (int j = 0; j < kMaxSlotsPerLane; ++j) w[j] = sl.pr[j];
    }
#pragma unroll
    for (int j = 0; j < kMaxSlotsPerLane; ++j) {
      const int k = lane + 32 * j;
      if (k < K) p.depth[((size_t)b * K + k) * HW + q] = w[j];
    }
    scatter_row(g, sl, w, bits, prefix, upad, W, K, lane, sc);
  }

  // (e)
  if constexpr (S::kMma)
    out_mma<NV>(vstages, stage_v, vchunks, G, qidx, nq, p.out + item * C, warp, lane);
  else
    out_fma<NV>(vstages, stage_v, vchunks, G, qidx, nq, p.out + item * C, warp, lane);
}

// ---- backward pass A: per query ------------------------------------------

// The weights w, the logit gradients ds and (dprior) the prior's gradient
// of query q from its similarities s and its g = dL/dw, by the header's
// formulas; each lane holds the samples k = lane + 32 i.
__device__ __forceinline__ void logit_grads(const Params& p, const Slots& sl, int lane, int b,
                                            int q, const float (&s)[kMaxSlotsPerLane],
                                            const float (&g)[kMaxSlotsPerLane],
                                            float (&w)[kMaxSlotsPerLane],
                                            float (&ds)[kMaxSlotsPerLane]) {
  const int K = p.K;
  float prob[kMaxSlotsPerLane];
  if (p.use_sim) {
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
      w[i] = prob[i] = sl.pr[i];
      ds[i] = 0.f;
    }
  }

  // the prior's gradient, by mode (the header's dprior)
  if (p.dprior != nullptr) {
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      const int k = lane + 32 * i;
      if (k >= K) continue;
      float dp;
      if (!p.use_sim) dp = g[i];
      else if (p.priormul) dp = p.softmax ? g[i] * prob[i] : 0.f;
      else dp = p.softmax ? ds[i] : g[i] / (float)K;
      p.dprior[((size_t)b * K + k) * p.H * p.W + q] = dp;
    }
  }
}


template <typename T, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
query_backward_kernel(const Params p, const unsigned char* done) {
  const int lane = threadIdx.x & 31;
  const int HW = p.H * p.W;
  const long long gq =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gq >= (long long)p.B * HW) return;  // uniform across the warp
  if (done != nullptr && done[gq]) return;  // the tile path wrote it
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

  // the weights, the logit gradient ds and the prior's gradient
  float w[kMaxSlotsPerLane], ds[kMaxSlotsPerLane];
  logit_grads(p, sl, lane, b, q, s, g, w, ds);

  // the coefficients of the key/value gradients, for pass B
  if (p.ds != nullptr) {
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      const int k = lane + 32 * i;
      if (k < K) {
        p.ds[(item + q) * K + k] = ds[i];
        p.w[(item + q) * K + k] = w[i];
      }
    }
  }

  // second sweep: dfeat1 in registers
  float acc[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) acc[t] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) {
    if (32 * i >= K) break;
    for (int j = 0; j < 32 && 32 * i + j < K; ++j) {
      const float dsk = __shfl_sync(kFull, ds[i], j);
      const Corners c = broadcast_corners(sl, i, j);
      if (dsk == 0.f) continue;  // warp-uniform, as are the corner weights
      if (c.c00 != 0.f) axpy_row<T, NV>(f2k + (size_t)c.base * C, dsk * c.c00, acc);
      if (c.c01 != 0.f) axpy_row<T, NV>(f2k + (size_t)(c.base + 1) * C, dsk * c.c01, acc);
      if (c.c10 != 0.f) axpy_row<T, NV>(f2k + (size_t)(c.base + W) * C, dsk * c.c10, acc);
      if (c.c11 != 0.f) axpy_row<T, NV>(f2k + (size_t)(c.base + W + 1) * C, dsk * c.c11, acc);
    }
  }
  store_row<NV>(p.dfeat1 + row, acc);
}

// ---- backward pass B: the CSR map from key rows to entries ---------------

// Entries of each (tile, key row): one block per (tile, item), counts in
// shared memory (integer atomics), written out whole.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tile_histogram_kernel(const Params p, const Transpose t) {
  extern __shared__ int count[];  // HW
  const int HW = p.H * p.W;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q1 = min((tile + 1) * kTile, HW);
  const int mine = tile * kTile + threadIdx.x;
  const int live =
      __syncthreads_or(mine < q1 && (t.done == nullptr || !t.done[(size_t)b * HW + mine]));
  if (threadIdx.x == 0) t.tile_live[b * t.tiles + tile] = live;
  if (!live) return;  // uniform: the tile path took all its queries
  for (int r = threadIdx.x; r < HW; r += blockDim.x) count[r] = 0;
  __syncthreads();
  for (int q = tile * kTile + warp; q < q1; q += kWarpsPerBlock) {
    if (t.done != nullptr && t.done[(size_t)b * HW + q]) continue;  // the tile path's
    for (int k = lane; k < p.K; k += 32) {
      const SampleCorners s = sample_corners(p, b, q, k);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (s.wc[c] != 0.f) atomicAdd(&count[s.row[c]], 1);
    }
  }
  __syncthreads();
  int* out = t.tile_rows + ((size_t)b * t.tiles + tile) * HW;
  for (int r = threadIdx.x; r < HW; r += blockDim.x) out[r] = count[r];
}

// Per key row g: the exclusive prefix of its entries over the item's tiles
// (in place), then the inclusive prefix of the row totals over this block of
// kScanThreads rows into row_ptr[g + 1], and the block's total.
__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(int B, int HW, const Transpose t) {
  __shared__ int warp_total[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  const bool live = g < (long long)B * HW;
  int run = 0;
  if (live) {
    const int b = (int)(g / HW);
    const int r = (int)(g - (long long)b * HW);
    int* col = t.tile_rows + (size_t)b * t.tiles * HW + r;
    const int* live = t.tile_live + (size_t)b * t.tiles;
    for (int tile = 0; tile < t.tiles; ++tile) {
      if (!live[tile]) continue;  // no entries
      const int c = col[(size_t)tile * HW];
      col[(size_t)tile * HW] = run;
      run += c;
    }
  }
  const int x = warp_inclusive_scan(run, lane);
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  if (warp == 0) warp_total[lane] = warp_inclusive_scan(warp_total[lane], lane);
  __syncthreads();
  const int inclusive = x + (warp > 0 ? warp_total[warp - 1] : 0);
  if (live) t.row_ptr[g + 1] = inclusive;
  if (threadIdx.x == kScanThreads - 1) t.block_total[blockIdx.x] = inclusive;
}

// Adds to each row's offset the entries of all earlier blocks of rows.
__global__ void __launch_bounds__(kScanThreads)
row_offset_kernel(int rows, const Transpose t) {
  __shared__ int before;
  if (threadIdx.x < 32) {
    int s = 0;
    for (int i = threadIdx.x; i < (int)blockIdx.x; i += 32) s += t.block_total[i];
    s = __reduce_add_sync(kFull, s);
    if (threadIdx.x == 0) before = s;
  }
  __syncthreads();
  const long long g = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  if (g < rows) t.row_ptr[g + 1] += before;
  if (g == 0) t.row_ptr[0] = 0;
}

// One query's samples as lane `lane` sees them (k = lane + 32 i); all
// weights are 0 for k >= K.
__device__ __forceinline__ void load_lane_samples(const Params& p, int b, int q,
                                                  int lane,
                                                  SampleCorners (&s)[kMaxSlotsPerLane]) {
#pragma unroll
  for (int i = 0; i < kMaxSlotsPerLane; ++i) s[i] = sample_corners(p, b, q, lane + 32 * i);
}

// One warp per (tile, item): the tile's entries into their rows' places,
// query by query.  cursor[r] starts at the row's offset plus the entries of
// earlier tiles; within a step, lanes with equal rows take consecutive
// places in lane order.  The next query's samples load while this one's
// entries are placed.
__global__ void __launch_bounds__(32) fill_kernel(const Params p, const Transpose t) {
  extern __shared__ int cursor[];  // HW
  const int HW = p.H * p.W;
  const int tile = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  if (!t.tile_live[b * t.tiles + tile]) return;  // no entries
  const int* before = t.tile_rows + ((size_t)b * t.tiles + tile) * HW;
  const int* row_ptr = t.row_ptr + (size_t)b * HW;
  for (int r = lane; r < HW; r += 32) cursor[r] = row_ptr[r] + before[r];
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  const int q0 = tile * kTile, q1 = min(q0 + kTile, HW);
  SampleCorners cur[kMaxSlotsPerLane], next[kMaxSlotsPerLane];
  load_lane_samples(p, b, q0, lane, cur);
  for (int q = q0; q < q1; ++q) {
    if (q + 1 < q1) load_lane_samples(p, b, q + 1, lane, next);
    const int gq = b * HW + q;
    const bool left = t.done == nullptr || !t.done[gq];  // not the tile path's
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) {
      if (!left || 32 * i >= p.K) break;  // uniform across the warp
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = cur[i].row[c];
        const float wc = cur[i].wc[c];
        const bool live = wc != 0.f;
        const unsigned mask = __ballot_sync(kFull, live);
        if (mask == 0u) continue;  // warp-uniform
        unsigned peers = 0u;
        int pos = 0;
        if (live) {
          peers = __match_any_sync(mask, r);
          pos = cursor[r] + __popc(peers & lower);
        }
        __syncwarp();
        if (live && (peers & lower) == 0u) cursor[r] += __popc(peers);
        __syncwarp();
        if (live) t.entry[pos] = gq << 9 | (lane + 32 * i) << 2 | c;
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxSlotsPerLane; ++i) cur[i] = next[i];
  }
}

// ---- backward pass C: per chunk of entries, then rows across chunks ------

// Fused: keys and values are one tensor, d1 = dother1 + dother2.
template <typename T, int NV, bool Fused>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_gather_kernel(const Params p, const Transpose t) {
  const int lane = threadIdx.x & 31;
  const int C = 32 * NV;
  const int HW = p.H * p.W;
  const int rows = p.B * HW;
  const int total = t.row_ptr[rows];
  const long long chunk =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long e0 = chunk * kChunk;
  if (e0 >= total) return;  // uniform across the warp
  const int e1 = (int)min(e0 + kChunk, (long long)total);
  const bool need1 = Fused || t.d1 != nullptr;
  const bool need2 = Fused || t.d2 != nullptr;

  // the row that holds entry e0: row_ptr[lo] <= e0 < row_ptr[lo + 1]
  int lo = 0, hi = rows;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.row_ptr[mid] <= e0) lo = mid; else hi = mid;
  }
  int g = lo;
  int row_end = t.row_ptr[g + 1];

  const T* f1 = static_cast<const T*>(p.f1) + lane * NV;
  const float* dout = p.dout + lane * NV;
  float acc1[NV], acc2[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc1[v] = acc2[v] = 0.f;

  for (int base = (int)e0; base < e1; base += 32) {
    const int n = min(32, e1 - base);
    // this lane's entry: its query, key row and coefficients ds w_c and
    // w w_c, with w_c formed from the slot data as the fill formed it
    int eq = -1, eg = -1;
    float ea = 0.f, eb = 0.f;
    if (lane < n) {
      const int e = t.entry[base + lane];
      eq = e >> 9;
      const int k = (e >> 2) & 127, c = e & 3;
      const int b = eq / HW;
      int rbase;
      float x0, x1, y0, y1;
      sample_slot(p, b, eq - b * HW, k, rbase, x0, x1, y0, y1);
      const float wc = ((c & 2) ? y1 : y0) * ((c & 1) ? x1 : x0);
      ea = p.ds[(size_t)eq * p.K + k] * wc;
      eb = p.w[(size_t)eq * p.K + k] * wc;
      eg = b * HW + rbase + ((c & 2) ? p.W : 0) + (c & 1);
    }
    // consecutive entries of one row from one query (two samples of a line
    // touch the row) are summed into the first, so its rows load once: a
    // suffix sum within runs, in a fixed order
    const int prev_q = __shfl_up_sync(kFull, eq, 1);  // every lane shuffles
    const int prev_g = __shfl_up_sync(kFull, eg, 1);
    const bool follows = lane > 0 && lane < n && prev_q == eq && prev_g == eg;
    const unsigned run = __ballot_sync(kFull, follows);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float ta = __shfl_down_sync(kFull, ea, o);
      const float tb = __shfl_down_sync(kFull, eb, o);
      if (lane + o < 32) {
        const unsigned span = ((1u << o) - 1u) << (lane + 1);  // lanes (lane, lane + o]
        if ((run & span) == span) {
          ea += ta;
          eb += tb;
        }
      }
    }
    if (follows) ea = eb = 0.f;
    for (int j = 0; j < n; j += kUnroll) {
      float a[kUnroll], bw[kUnroll];
      float v1[kUnroll][NV], v2[kUnroll][NV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int src = (j + u) & 31;
        const int qq = __shfl_sync(kFull, eq, src);
        a[u] = __shfl_sync(kFull, ea, src);
        bw[u] = __shfl_sync(kFull, eb, src);
        if (j + u >= n) a[u] = bw[u] = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) v1[u][v] = v2[u][v] = 0.f;
        if (need1 && a[u] != 0.f) load_row<NV>(f1 + (size_t)qq * C, v1[u]);
        if (need2 && bw[u] != 0.f) load_row<NV>(dout + (size_t)qq * C, v2[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u >= n) break;  // warp-uniform
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          if constexpr (Fused) {
            acc1[v] = fmaf(a[u], v1[u][v], acc1[v]);
            acc1[v] = fmaf(bw[u], v2[u][v], acc1[v]);
          } else {
            acc1[v] = fmaf(a[u], v1[u][v], acc1[v]);
            acc2[v] = fmaf(bw[u], v2[u][v], acc2[v]);
          }
        }
        const int e = base + j + u;
        if (e + 1 == row_end || e + 1 == e1) {
          // a row inside the chunk is written once; a row that crosses
          // the chunk's edges leaves its partial sum in slot 0 (the
          // chunk's first row) or 1 (its last)
          const int rs = t.row_ptr[g];
          float* dst1;
          float* dst2;
          if (rs >= e0 && row_end <= e0 + kChunk) {
            dst1 = t.d1 == nullptr ? nullptr : t.d1 + (size_t)g * C;
            dst2 = t.d2 == nullptr ? nullptr : t.d2 + (size_t)g * C;
          } else {
            const size_t slot = ((size_t)chunk * 2 + (rs <= e0 ? 0 : 1)) * C;
            dst1 = t.d1 == nullptr ? nullptr : t.part1 + slot;
            dst2 = t.d2 == nullptr ? nullptr : t.part2 + slot;
          }
          if (dst1 != nullptr) store_row<NV>(dst1 + lane * NV, acc1);
          if (!Fused && dst2 != nullptr) store_row<NV>(dst2 + lane * NV, acc2);
#pragma unroll
          for (int v = 0; v < NV; ++v) acc1[v] = acc2[v] = 0.f;
          if (e + 1 < e1) {  // next non-empty row
            do { ++g; } while (t.row_ptr[g + 1] <= e + 1);
            row_end = t.row_ptr[g + 1];
          }
        }
      }
    }
  }
}

// One warp per key row: an empty row is written as zeros; a row that crosses
// chunks is the sum of its partials in chunk order; any other row was
// written by row_gather_kernel.
template <int NV>
__device__ __forceinline__ void fixup_row(const float* part,
                                          float* out, int g, int rs, int re,
                                          int lane) {
  const int C = 32 * NV;
  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.f;
  if (re > rs) {
    const int c0 = rs / kChunk, c1 = (re - 1) / kChunk;
    for (int c = c0; c <= c1; ++c) {
      const int slot = (c == c0 && rs != c0 * kChunk) ? 1 : 0;
      float v[NV];
      load_row<NV>(part + ((size_t)c * 2 + slot) * C + lane * NV, v);
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] += v[i];
    }
  }
  store_row<NV>(out + (size_t)g * C + lane * NV, acc);
}

template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_fixup_kernel(int rows, const Transpose t) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= rows) return;
  const int rs = t.row_ptr[g], re = t.row_ptr[g + 1];
  if (re > rs && rs / kChunk == (re - 1) / kChunk) return;  // inside one chunk
  if (re == rs && t.reduced) return;  // empty: the row reduction writes it
  if (t.d1 != nullptr) fixup_row<NV>(t.part1, t.d1, (int)g, rs, re, lane);
  if (t.d2 != nullptr) fixup_row<NV>(t.part2, t.d2, (int)g, rs, re, lane);
}

// ---- backward, tile path: one CTA per tile of kTileQ queries --------------

constexpr int kBwdUnion = 320;         // key rows a backward tile may stage
constexpr int kBwdGS = kBwdUnion + 4;  // row stride of G, D and N (16-byte rows)
constexpr int kBwdCW = 16;             // features a row per stage of a Gram product
constexpr int kBwdKeyRows = 16;        // key rows per stage of dfeat1 = D K_U
// 16 warps: with one CTA on an SM, the per-query steps (d), (g) are
// latency-bound, and twice the forward's 8 warps took ~11% off the tile
// kernel at the flagship on an H100 (1.0815-1.0886 ms against
// 1.2237-1.2241 for the whole backward, one call in turns)
constexpr int kBwdThreads = 512;
constexpr int kBwdRows = kTileQ / (kBwdThreads / 32);  // queries a warp owns: 4

// Shared memory of the backward tile kernel, in floats.  The big region
// holds the two stages of a Gram product (the tile's query-side rows and
// the union's key rows, kBwdCW features each, QKS floats a row); or the
// tile's matrix M (G, then D, then N; kTileQ x kBwdGS) and after it either
// two stages of kBwdKeyRows key rows or the tile's F1 or dOut rows.
// Everything in shared memory is f32: bf16 rows are converted as they are
// staged.  Then the per-sample g, later w (kTileQ x K), the union's bitmap,
// prefix and rows, the queries and the scratch of the row scatter.
template <int NV>
struct BwdShape {
  static constexpr int C = 32 * NV;
  static constexpr int QKS = kBwdCW + 1;  // odd: a column of 32 rows hits 32 banks
  static constexpr int kStage = (kTileQ + kBwdUnion) * QKS;
  static constexpr int kMat = kTileQ * kBwdGS;
  static constexpr int kKeys = 2 * kBwdKeyRows * C;
  static constexpr int kRows = kTileQ * C;
  static constexpr int kAfter = kKeys > kRows ? kKeys : kRows;
  static constexpr int kBig = 2 * kStage > kMat + kAfter ? 2 * kStage : kMat + kAfter;
  static size_t bytes(int HW, int K) {
    const int HWW = (HW + 31) / 32;
    return (size_t)(kBig + kTileQ * K + 2 * HWW + kBwdUnion + kTileQ + kBwdThreads + 4) * 4;
  }
};

// The tile path's share of the key/value gradients, in the caller's scratch.
struct TileGrads {
  int tiles;       // tiles per item
  unsigned* bits;  // (B, tiles, HWW) each tile's union bitmap, 0 off the tile path
  int* prefix;     // (B, tiles, HWW) the exclusive prefix of its words' populations
  float* part1;    // (B, tiles, kBwdUnion, C) D^T F1 (+ N^T dOut when fused), or null
  float* part2;    // (B, tiles, kBwdUnion, C) N^T dOut, or null
  int fused;       // keys and values one tensor: part1 holds both partials
  int max_union;   // union rows a tile may hold, at most kBwdUnion
  const int* item_lines;  // (B) the schedule's: 0 where no tile took the tile path
};

// Four features of a global row into shared floats: f32 by cp.async, bf16
// through registers.  The aligned forms need a 16-byte destination.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < 4; ++i) cp_async4(dst + i, src + i);
}

__device__ __forceinline__ float4 bf16x4(const __nv_bfloat16* src) {
  const uint2 t = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void copy4(float* dst, const __nv_bfloat16* src) {
  const float4 v = bf16x4(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void copy4_aligned(float* dst, const float* src) {
  cp_async16(dst, src);
}

__device__ __forceinline__ void copy4_aligned(float* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<float4*>(dst) = bf16x4(src);
}

// One stage of a Gram product: features [kBwdCW chunk, + kBwdCW) of the
// tile's query-side rows `a` (stage rows 0..nq) and of the union's key rows
// `kv` (stage rows kTileQ + u), both from the item's base.
template <int NV, typename TA, typename TB>
struct GramStage {
  const TA* a;
  const TB* kv;
  const int* qidx;
  const int* rows;
  int nq, U, tid;
  float* big;
  __device__ __forceinline__ void operator()(int chunk, int buf) const {
    constexpr int C = 32 * NV, QKS = BwdShape<NV>::QKS, kUnits = kBwdCW / 4;
    float* dst = big + buf * BwdShape<NV>::kStage;
    for (int e = tid; e < (kTileQ + U) * kUnits; e += kBwdThreads) {
      const int r = e / kUnits, f = 4 * (e - r * kUnits), col = chunk * kBwdCW + f;
      if (r < kTileQ) {
        if (r < nq) copy4(dst + r * QKS + f, a + (size_t)qidx[r] * C + col);
      } else {
        copy4(dst + r * QKS + f, kv + (size_t)rows[r - kTileQ] * C + col);
      }
    }
    cp_async_commit();
  }
};

// One stage of dfeat1 = D K_U: kBwdKeyRows union rows of the keys, zeros
// past the union.
template <int NV, typename T>
struct KeyStage {
  const T* keys;
  const int* rows;
  int U, tid;
  float* dst;
  __device__ __forceinline__ void operator()(int chunk, int buf) const {
    constexpr int C = 32 * NV, kUnits = C / 4;
    float* d = dst + buf * kBwdKeyRows * C;
    for (int e = tid; e < kBwdKeyRows * kUnits; e += kBwdThreads) {
      const int r = e / kUnits, f = 4 * (e - r * kUnits), u = chunk * kBwdKeyRows + r;
      if (u < U)
        copy4_aligned(d + r * C + f, keys + (size_t)rows[u] * C + f);
      else
        *reinterpret_cast<float4*>(d + r * C + f) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
  }
};

// The tile's rows of `src` (F1 or dOut), nq of them, C floats a row.
template <int NV, typename TS>
__device__ __forceinline__ void stage_tile_rows(float* dst, const TS* src, const int* qidx,
                                                int nq, int tid) {
  constexpr int C = 32 * NV, kUnits = C / 4;
  for (int e = tid; e < nq * kUnits; e += kBwdThreads) {
    const int r = e / kUnits, f = 4 * (e - r * kUnits);
    copy4_aligned(dst + r * C + f, src + (size_t)qidx[r] * C + f);
  }
  cp_async_commit();
}

// M = A_tile B_union^T (kTileQ x 32 NG, NG even) on CUDA cores in f32, as
// gram_fma: warp w holds query rows kRowsPerWarp (w % 8) + i, lane the
// columns lane + 32 (w / 8) + 64 n.  Columns past the union read stale
// stage rows; they are never used.  M lands in the stages' place.
template <int NV, int NG, typename Stage>
__device__ __forceinline__ void bwd_gram(float* big, const Stage& stage, int warp, int lane) {
  using S = BwdShape<NV>;
  constexpr int QKS = S::QKS, kChunks = S::C / kBwdCW, NH = NG / 2;
  const int m0 = kRowsPerWarp * (warp & 7), h = warp >> 3;
  float acc[kRowsPerWarp][NH];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int n = 0; n < NH; ++n) acc[i][n] = 0.f;
  stage(0, 0);
  for (int chunk = 0; chunk < kChunks; ++chunk) {
    if (chunk + 1 < kChunks) {
      stage(chunk + 1, (chunk + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = big + (chunk & 1) * S::kStage;
    const float* qs = st + m0 * QKS;
    const float* ks = st + (kTileQ + lane + 32 * h) * QKS;
#pragma unroll 4
    for (int w = 0; w < kBwdCW; ++w) {
      float qv[kRowsPerWarp], kv[NH];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) qv[i] = qs[i * QKS + w];
#pragma unroll
      for (int n = 0; n < NH; ++n) kv[n] = ks[n * 64 * QKS + w];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int n = 0; n < NH; ++n) acc[i][n] = fmaf(qv[i], kv[n], acc[i][n]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int n = 0; n < NH; ++n)
      big[(m0 + i) * kBwdGS + lane + 32 * h + 64 * n] = acc[i][n];
  __syncthreads();  // the rows are read by other warps next
}

// The 64-column pairs the union needs.
template <int NV, typename Stage>
__device__ __forceinline__ void bwd_gram_u(float* big, const Stage& stage, int U, int warp,
                                           int lane) {
  if (U <= 64)
    bwd_gram<NV, 2>(big, stage, warp, lane);
  else if (U <= 128)
    bwd_gram<NV, 4>(big, stage, warp, lane);
  else if (U <= 192)
    bwd_gram<NV, 6>(big, stage, warp, lane);
  else if (U <= 256)
    bwd_gram<NV, 8>(big, stage, warp, lane);
  else
    bwd_gram<NV, 10>(big, stage, warp, lane);
}

// dfeat1 = D K_U on CUDA cores, as out_fma: warp w holds query rows
// kBwdRows w + i, lane the channels lane + 32 n; the first stage was
// issued by the caller.
template <int NV, typename Stage>
__device__ __forceinline__ void dfeat1_fma(const float* D, const float* kstages,
                                           const Stage& stage, int chunks, const int* qidx,
                                           int nq, float* out, int warp, int lane) {
  constexpr int C = 32 * NV;
  float acc[kBwdRows][NV];
#pragma unroll
  for (int i = 0; i < kBwdRows; ++i)
#pragma unroll
    for (int n = 0; n < NV; ++n) acc[i][n] = 0.f;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk + 1 < chunks) {
      stage(chunk + 1, (chunk + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* vs = kstages + (chunk & 1) * kBwdKeyRows * C;
    const float* drow = D + warp * kBwdRows * kBwdGS + chunk * kBwdKeyRows;
#pragma unroll 4
    for (int r = 0; r < kBwdKeyRows; ++r) {
      float dv[kBwdRows], v[NV];
#pragma unroll
      for (int i = 0; i < kBwdRows; ++i) dv[i] = drow[i * kBwdGS + r];
#pragma unroll
      for (int n = 0; n < NV; ++n) v[n] = vs[r * C + lane + 32 * n];
#pragma unroll
      for (int i = 0; i < kBwdRows; ++i)
#pragma unroll
        for (int n = 0; n < NV; ++n) acc[i][n] = fmaf(dv[i], v[n], acc[i][n]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kBwdRows; ++i) {
    const int r = warp * kBwdRows + i;
    if (r >= nq) break;
    float* o = out + (size_t)qidx[r] * C + lane;
#pragma unroll
    for (int n = 0; n < NV; ++n) o[32 * n] = acc[i][n];
  }
}

// out[u] = sum_q M[q, u] X[q] (+ out[u] when add) for the union rows u < U
// on CUDA cores: warp w takes the groups of 8 rows from 8 w in steps of 64,
// lane the channels lane + 32 n; M is D or N (rows padded with zeros to a
// multiple of 16 columns), X the tile's staged rows.  A thread adds to
// what it wrote itself.
template <int NV>
__device__ __forceinline__ void partial_fma(const float* M, const float* X, int nq, int U,
                                            float* out, bool add, int warp, int lane) {
  constexpr int C = 32 * NV;
  for (int u0 = 8 * warp; u0 < U; u0 += 8 * kBwdThreads / 32) {
    float acc[8][NV];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[i][n] = 0.f;
#pragma unroll 2
    for (int q = 0; q < nq; ++q) {
      const float4 m0 = *reinterpret_cast<const float4*>(M + q * kBwdGS + u0);
      const float4 m1 = *reinterpret_cast<const float4*>(M + q * kBwdGS + u0 + 4);
      const float m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      float x[NV];
#pragma unroll
      for (int n = 0; n < NV; ++n) x[n] = X[q * C + lane + 32 * n];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < NV; ++n) acc[i][n] = fmaf(m[i], x[n], acc[i][n]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (u0 + i >= U) break;
      float* o = out + (size_t)(u0 + i) * C + lane;
#pragma unroll
      for (int n = 0; n < NV; ++n) o[32 * n] = add ? o[32 * n] + acc[i][n] : acc[i][n];
    }
  }
}

// (a) the union of the tile's live corner rows, as the forward's tile
// kernel forms it; a tile whose union exceeds tg.max_union, or of an item
// without lines, is left to the per-query passes.  (b) Gd = dOut_tile
// V_U^T and each query's g from its live-corner slots; (c) G = F1_tile
// K_U^T; (d) per query (one warp per query, in turn): sims from G, w, ds
// and dprior by the per-query rules, then D's row in place of G's; (e)
// dfeat1 = D K_U; (f) the keys' partial D^T F1_tile; (g) N's rows in place
// of D's and the values' partial N^T dOut_tile, added to the keys' when
// keys and values are one tensor.  The partials go to the tile's place in
// scratch, its union's bitmap and prefix beside them, for the row
// reduction.  Shared memory (BwdShape) holds one CTA of kBwdThreads on an
// SM; warp w owns the queries kBwdRows w + i in (b), (d) and (g).
template <typename T, int NV>
__global__ void __launch_bounds__(kBwdThreads, 1)
tile_backward_kernel(const Params p, const Schedule sch, const TileGrads tg) {
  using S = BwdShape<NV>;
  constexpr int C = 32 * NV, GS = kBwdGS;
  const int HW = p.H * p.W, HWW = (HW + 31) / 32, K = p.K, W = p.W;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(kTileQ, HW - tile * kTileQ);
  const size_t item = (size_t)b * HW;
  const size_t at = (size_t)b * tg.tiles + tile;
  unsigned* gbits = tg.bits == nullptr ? nullptr : tg.bits + at * HWW;
  if (!sch.item_lines[b]) {  // uniform: no lines to group by
    if (tid == 0) atomicAdd(&sch.tile_counts[1], 1);
    if (gbits != nullptr)
      for (int i = tid; i < HWW; i += kBwdThreads) gbits[i] = 0u;
    return;
  }

  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* big = reinterpret_cast<float*>(bwd_smem);
  float* wk = big + S::kBig;  // (kTileQ, K): g, then w
  unsigned* bits = reinterpret_cast<unsigned*>(wk + kTileQ * K);
  int* prefix = reinterpret_cast<int*>(bits + HWW);
  int* rows = prefix + HWW;
  int* qidx = rows + kBwdUnion;
  float* scratch = reinterpret_cast<float*>(qidx + kTileQ);
  int* nunion = reinterpret_cast<int*>(scratch + kBwdThreads);

  // (a)
  const int U = tile_union<kBwdThreads>(p, sch, b, tile, qidx, bits, prefix, nunion);
  if (U > tg.max_union) {  // uniform across the block
    if (tid == 0) atomicAdd(&sch.tile_counts[1], 1);
    if (gbits != nullptr)
      for (int i = tid; i < HWW; i += kBwdThreads) gbits[i] = 0u;
    return;
  }
  if (tid == 0) atomicAdd(&sch.tile_counts[0], 1);
  if (tid < nq) sch.done[item + qidx[tid]] = 1;
  for (int i = tid; i < HWW; i += kBwdThreads) {
    compact_word(bits, prefix, rows, i);
    if (gbits != nullptr) {
      gbits[i] = bits[i];
      tg.prefix[at * HWW + i] = prefix[i];
    }
  }
  __syncthreads();

  const T* f1 = static_cast<const T*>(p.f1) + item * C;
  const T* f2k = static_cast<const T*>(p.f2k) + item * C;
  const T* f2v = static_cast<const T*>(p.f2v) + item * C;
  const float* dout = p.dout + item * C;
  float* M = big;                   // (kTileQ, GS): Gd, then G, D and N
  float* after = big + S::kMat;     // key stages, or the tile's F1 or dOut rows
  float* sc = scratch + warp * 32;
  const int upad = (U + kBwdKeyRows - 1) / kBwdKeyRows * kBwdKeyRows;
  const int first = warp * kBwdRows;

  // (b)
  bwd_gram_u<NV>(big, GramStage<NV, float, T>{dout, f2v, qidx, rows, nq, U, tid, big}, U, warp,
                 lane);
  for (int i = 0; i < kBwdRows; ++i) {
    const int r = first + i;
    if (r >= nq) break;  // uniform across the warp
    Slots sl;
    load_slots(p, b, qidx[r], lane, sl);
#pragma unroll
    for (int j = 0; j < kMaxSlotsPerLane; ++j)
      if (lane + 32 * j < K) wk[r * K + lane + 32 * j] = corner_sum(M + r * GS, sl, j, bits, prefix, W);
  }

  // (c)
  if (p.use_sim) {  // uniform across the block
    __syncthreads();
    bwd_gram_u<NV>(big, GramStage<NV, T, T>{f1, f2k, qidx, rows, nq, U, tid, big}, U, warp, lane);
  }

  // the first key rows of (e) load while D is formed
  const KeyStage<NV, T> stage_k{f2k, rows, U, tid, after};
  const int kchunks = upad / kBwdKeyRows;
  if (kchunks > 0) stage_k(0, 0);

  // (d)
  for (int i = 0; i < kBwdRows; ++i) {
    const int r = first + i;
    if (r >= nq) break;  // uniform across the warp
    const int q = qidx[r];
    float* row = M + r * GS;
    Slots sl;
    load_slots(p, b, q, lane, sl);
    float s[kMaxSlotsPerLane], g[kMaxSlotsPerLane], w[kMaxSlotsPerLane], ds[kMaxSlotsPerLane];
#pragma unroll
    for (int j = 0; j < kMaxSlotsPerLane; ++j) {
      const int k = lane + 32 * j;
      g[j] = k < K ? wk[r * K + k] : 0.f;
      s[j] = p.use_sim ? corner_sum(row, sl, j, bits, prefix, W) : 0.f;
    }
    logit_grads(p, sl, lane, b, q, s, g, w, ds);
#pragma unroll
    for (int j = 0; j < kMaxSlotsPerLane; ++j)
      if (lane + 32 * j < K) wk[r * K + lane + 32 * j] = w[j];
    scatter_row(row, sl, ds, bits, prefix, upad, W, K, lane, sc);
  }

  // (e)
  dfeat1_fma<NV>(M, after, stage_k, kchunks, qidx, nq, p.dfeat1 + item * C, warp, lane);

  // (f)
  const size_t part = at * kBwdUnion * C;
  if (tg.part1 != nullptr) {  // uniform across the block
    __syncthreads();
    stage_tile_rows<NV>(after, f1, qidx, nq, tid);
    cp_async_wait<0>();
    __syncthreads();
    partial_fma<NV>(M, after, nq, U, tg.part1 + part, false, warp, lane);
  }

  // (g)
  if (tg.part2 != nullptr || tg.fused) {  // uniform across the block
    __syncthreads();
    stage_tile_rows<NV>(after, dout, qidx, nq, tid);
    for (int i = 0; i < kBwdRows; ++i) {
      const int r = first + i;
      if (r >= nq) break;  // uniform across the warp
      Slots sl;
      load_slots(p, b, qidx[r], lane, sl);
      float w[kMaxSlotsPerLane];
#pragma unroll
      for (int j = 0; j < kMaxSlotsPerLane; ++j) {
        const int k = lane + 32 * j;
        w[j] = k < K ? wk[r * K + k] : 0.f;
      }
      scatter_row(M + r * GS, sl, w, bits, prefix, upad, W, K, lane, sc);
    }
    cp_async_wait<0>();
    __syncthreads();
    partial_fma<NV>(M, after, nq, U, (tg.fused ? tg.part1 : tg.part2) + part, tg.fused != 0,
                    warp, lane);
  }
}

// One warp per key row: its partials from the tiles whose union holds it,
// summed in tile order, then the sum of the CSR passes over the queries
// the tile path left (in d1 / d2 already where the row has entries) added;
// part1 feeds d1, part2 d2.  An empty row is written here (zeros where no
// tile holds it).
template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tile_reduce_kernel(int rows, int HW, const TileGrads tg, const Transpose t) {
  constexpr int C = 32 * NV;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= rows) return;  // uniform across the warp
  const int b = (int)(g / HW), r = (int)(g - (long long)b * HW);
  const int HWW = (HW + 31) / 32, word = r >> 5;
  const unsigned below = (1u << (r & 31)) - 1u;
  const size_t first = (size_t)b * tg.tiles;
  const bool csr = t.row_ptr[g + 1] != t.row_ptr[g];
  if (!tg.item_lines[b] && csr) return;  // uniform: no tile holds the row
  float acc1[NV], acc2[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc1[v] = acc2[v] = 0.f;
  for (int t0 = 0; tg.item_lines[b] && t0 < tg.tiles; t0 += 32) {
    unsigned bw = 0u;
    int slot = 0;
    if (t0 + lane < tg.tiles) {
      const size_t w = (first + t0 + lane) * HWW + word;
      bw = tg.bits[w];
      slot = tg.prefix[w] + __popc(bw & below);
    }
    const unsigned hit = __ballot_sync(kFull, (bw >> (r & 31)) & 1u);
    for (unsigned m = hit; m != 0u; m &= m - 1u) {  // tile order
      const int src = __ffs(m) - 1;
      const int s = __shfl_sync(kFull, slot, src);
      const size_t at = ((first + t0 + src) * kBwdUnion + s) * C + lane * NV;
      float v[NV];
      if (t.d1 != nullptr) {
        load_row<NV>(tg.part1 + at, v);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc1[i] += v[i];
      }
      if (t.d2 != nullptr) {
        load_row<NV>(tg.part2 + at, v);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc2[i] += v[i];
      }
    }
  }
  const size_t out = (size_t)g * C + lane * NV;
  float v[NV];
  if (t.d1 != nullptr) {
    if (csr) {
      load_row<NV>(t.d1 + out, v);
#pragma unroll
      for (int i = 0; i < NV; ++i) acc1[i] += v[i];
    }
    store_row<NV>(t.d1 + out, acc1);
  }
  if (t.d2 != nullptr) {
    if (csr) {
      load_row<NV>(t.d2 + out, v);
#pragma unroll
      for (int i = 0; i < NV; ++i) acc2[i] += v[i];
    }
    store_row<NV>(t.d2 + out, acc2);
  }
}

// ---- launches ------------------------------------------------------------

long long max_entries(int B, int H, int W, int K) {
  return (long long)B * H * W * K * 4;
}

long long max_chunks(int B, int H, int W, int K) {
  return (max_entries(B, H, W, K) + kChunk - 1) / kChunk;
}

int tiles_per_item(int H, int W) { return (H * W + kTile - 1) / kTile; }

size_t align_up(size_t n) { return (n + 255) & ~(size_t)255; }

// The pieces of the backward's scratch, in order; returns the bytes used.
// With `base`, points p and t (whose d1/d2 are already set) into it.
size_t carve(char* base, int B, int H, int W, int K, int C, int partials,
             Params* p, Transpose* t) {
  const size_t rows = (size_t)B * H * W;
  const size_t entries = (size_t)max_entries(B, H, W, K);
  const size_t pieces[] = {
      rows * K * sizeof(float),                            // ds
      rows * K * sizeof(float),                            // w
      (size_t)B * tiles_per_item(H, W) * sizeof(int),      // tile_live
      (size_t)B * tiles_per_item(H, W) * H * W * sizeof(int),  // tile_rows
      (rows + 1) * sizeof(int),                            // row_ptr
      (rows + kScanThreads - 1) / kScanThreads * sizeof(int),  // block_total
      entries * sizeof(int),                               // entry
      (size_t)max_chunks(B, H, W, K) * 2 * C * sizeof(float) * partials,
  };
  size_t off[8];
  size_t used = 0;
  for (int i = 0; i < 8; ++i) {
    off[i] = used;
    used += align_up(pieces[i]);
  }
  if (base != nullptr) {
    p->ds = reinterpret_cast<float*>(base + off[0]);
    p->w = reinterpret_cast<float*>(base + off[1]);
    t->tiles = tiles_per_item(H, W);
    t->tile_live = reinterpret_cast<int*>(base + off[2]);
    t->tile_rows = reinterpret_cast<int*>(base + off[3]);
    t->row_ptr = reinterpret_cast<int*>(base + off[4]);
    t->block_total = reinterpret_cast<int*>(base + off[5]);
    t->entry = reinterpret_cast<int*>(base + off[6]);
    // one set of partials serves whichever single output is wanted
    float* part = reinterpret_cast<float*>(base + off[7]);
    t->part1 = t->d1 != nullptr ? part : nullptr;
    t->part2 = t->d2 == nullptr ? nullptr
               : t->d1 != nullptr ? part + (size_t)max_chunks(B, H, W, K) * 2 * C : part;
  }
  return used;
}

// The forward's tile schedule takes items of at most kMaxTileHW key rows
// (the grouping's keys and cursors and the tile's bitmap live in shared
// memory); other shapes run the per-query kernel on every query.
bool tile_shape(int B, int H, int W) {
  return (long long)H * W <= kMaxTileHW && (long long)B * H * W < (1ll << 31);
}

// The forward's scratch: the path counts, the items' line flags, the query
// order, the queries done; returns the bytes used.  With `base`, points sch
// into it.
size_t carve_forward(char* base, int B, int H, int W, Schedule* sch) {
  const size_t pieces[] = {
      2 * sizeof(int),                  // tile_counts
      (size_t)B * sizeof(int),          // item_lines
      (size_t)B * H * W * sizeof(int),  // perm
      (size_t)B * H * W,                // done
  };
  size_t off[4];
  size_t used = 0;
  for (int i = 0; i < 4; ++i) {
    off[i] = used;
    used += align_up(pieces[i]);
  }
  if (base != nullptr) {
    sch->tile_counts = reinterpret_cast<int*>(base + off[0]);
    sch->item_lines = reinterpret_cast<int*>(base + off[1]);
    sch->perm = reinterpret_cast<int*>(base + off[2]);
    sch->done = reinterpret_cast<unsigned char*>(base + off[3]);
  }
  return used;
}

// The grouping: each item's queries in line order, the path counts zeroed.
cudaError_t launch_group(const Params& p, const Schedule& sch, cudaStream_t stream) {
  const size_t gsmem = (size_t)(2 * p.H * p.W + 1) * sizeof(int);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)gsmem)) != cudaSuccess)
    return err;
  group_kernel<<<p.B, kGroupThreads, gsmem, stream>>>(p, sch);
  return cudaGetLastError();
}

// The backward's scratch: with the tile schedule, the forward's pieces
// (the path counts first) and, with key/value gradients, each tile's union
// bitmap and prefix and its `partials` sets of partials, kBwdUnion rows a
// tile (B x tiles x 320 x C x 4 bytes each: 168 MB at B=8 64x64 C=256,
// 1.5 GB at B=32 96x96; a tile writes its U rows); then, with key/value
// gradients, the transpose (carve).  Returns the bytes used; with `base`,
// points p, t, sch and tg (whose `fused` the caller sets) into it.
size_t carve_backward(char* base, int B, int H, int W, int K, int C, int partials, bool tiles,
                      Params* p, Transpose* t, Schedule* sch, TileGrads* tg) {
  size_t used = 0;
  if (tiles) {
    used = carve_forward(base, B, H, W, sch);
    const int ntiles = (H * W + kTileQ - 1) / kTileQ;
    const size_t words = (size_t)B * ntiles * ((H * W + 31) / 32);
    const size_t part = (size_t)B * ntiles * kBwdUnion * C;
    const size_t pieces[] = {
        partials ? words * sizeof(unsigned) : 0,  // bits
        partials ? words * sizeof(int) : 0,       // prefix
        part * sizeof(float) * partials,          // part1, part2
    };
    size_t off[3];
    for (int i = 0; i < 3; ++i) {
      off[i] = used;
      used += align_up(pieces[i]);
    }
    if (base != nullptr) {
      tg->tiles = ntiles;
      tg->item_lines = sch->item_lines;
      if (partials) {
        tg->bits = reinterpret_cast<unsigned*>(base + off[0]);
        tg->prefix = reinterpret_cast<int*>(base + off[1]);
        float* part0 = reinterpret_cast<float*>(base + off[2]);
        tg->part1 = t->d1 != nullptr ? part0 : nullptr;
        tg->part2 = t->d2 == nullptr ? nullptr : t->d1 != nullptr ? part0 + part : part0;
      }
    }
  }
  if (partials) used += carve(base == nullptr ? nullptr : base + used, B, H, W, K, C, partials, p, t);
  return used;
}

// With the tile schedule: grouping, the tile kernel, then the per-query
// kernel over the queries it left.  Without: the per-query kernel over all.
template <typename T, int NV>
cudaError_t launch_forward_nv(const Params& p, const Schedule* sch, cudaStream_t stream) {
  const int HW = p.H * p.W;
  cudaError_t err;
  if (sch != nullptr) {
    if ((err = launch_group(p, *sch, stream)) != cudaSuccess) return err;
    const size_t tsmem = TileShape<T, NV>::bytes(HW);
    if ((err = cudaFuncSetAttribute(tile_forward_kernel<T, NV>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)tsmem)) != cudaSuccess)
      return err;
    const unsigned tiles = (unsigned)((HW + kTileQ - 1) / kTileQ);
    tile_forward_kernel<T, NV><<<dim3(tiles, (unsigned)p.B), kTileThreads, tsmem, stream>>>(p, *sch);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long queries = (long long)p.B * HW;
  const dim3 grid((unsigned)((queries + kWarpsPerBlock - 1) / kWarpsPerBlock));
  epipolar_attention_kernel<T, NV><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      p, sch == nullptr ? nullptr : sch->done);
  return cudaGetLastError();
}

// With the tile schedule: grouping, the tile kernel, then pass A over the
// queries it left (sch->done).  Without: pass A over all.
template <typename T, int NV>
cudaError_t launch_backward_nv(const Params& p, const Schedule* sch, const TileGrads& tg,
                               cudaStream_t stream) {
  const int HW = p.H * p.W;
  cudaError_t err;
  if (sch != nullptr) {
    if ((err = launch_group(p, *sch, stream)) != cudaSuccess) return err;
    const size_t tsmem = BwdShape<NV>::bytes(HW, p.K);
    if ((err = cudaFuncSetAttribute(tile_backward_kernel<T, NV>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)tsmem)) != cudaSuccess)
      return err;
    tile_backward_kernel<T, NV><<<dim3((unsigned)tg.tiles, (unsigned)p.B), kBwdThreads, tsmem,
                                  stream>>>(p, *sch, tg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long queries = (long long)p.B * HW;
  const dim3 grid((unsigned)((queries + kWarpsPerBlock - 1) / kWarpsPerBlock));
  query_backward_kernel<T, NV><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      p, sch == nullptr ? nullptr : sch->done);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_forward(const Params& p, const Schedule* sch, int C, cudaStream_t stream) {
  switch (C) {
    case 32: return launch_forward_nv<T, 1>(p, sch, stream);
    case 64: return launch_forward_nv<T, 2>(p, sch, stream);
    case 128: return launch_forward_nv<T, 4>(p, sch, stream);
    case 256: return launch_forward_nv<T, 8>(p, sch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_backward(const Params& p, const Schedule* sch, const TileGrads& tg, int C,
                            cudaStream_t stream) {
  switch (C) {
    case 32: return launch_backward_nv<T, 1>(p, sch, tg, stream);
    case 64: return launch_backward_nv<T, 2>(p, sch, tg, stream);
    case 128: return launch_backward_nv<T, 4>(p, sch, tg, stream);
    case 256: return launch_backward_nv<T, 8>(p, sch, tg, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The row reduction of the tile path's partials into the CSR passes' sums.
cudaError_t launch_reduce(const Params& p, const TileGrads& tg, const Transpose& t, int C,
                          cudaStream_t stream) {
  const int rows = p.B * p.H * p.W, HW = p.H * p.W;
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  switch (C) {
    case 32: tile_reduce_kernel<1><<<grid, block, 0, stream>>>(rows, HW, tg, t); break;
    case 64: tile_reduce_kernel<2><<<grid, block, 0, stream>>>(rows, HW, tg, t); break;
    case 128: tile_reduce_kernel<4><<<grid, block, 0, stream>>>(rows, HW, tg, t); break;
    case 256: tile_reduce_kernel<8><<<grid, block, 0, stream>>>(rows, HW, tg, t); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int NV>
void launch_gather_nv(const Params& p, const Transpose& t, bool fused,
                      cudaStream_t stream) {
  const long long chunks = max_chunks(p.B, p.H, p.W, p.K);
  const dim3 grid((unsigned)((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  if (fused)
    row_gather_kernel<T, NV, true><<<grid, block, 0, stream>>>(p, t);
  else
    row_gather_kernel<T, NV, false><<<grid, block, 0, stream>>>(p, t);
  const int rows = p.B * p.H * p.W;
  row_fixup_kernel<NV><<<(rows + kWarpsPerBlock - 1) / kWarpsPerBlock, block, 0,
                         stream>>>(rows, t);
}

template <typename T>
cudaError_t launch_gather(const Params& p, const Transpose& t, int C, bool fused,
                          cudaStream_t stream) {
  switch (C) {
    case 32: launch_gather_nv<T, 1>(p, t, fused, stream); break;
    case 64: launch_gather_nv<T, 2>(p, t, fused, stream); break;
    case 128: launch_gather_nv<T, 4>(p, t, fused, stream); break;
    case 256: launch_gather_nv<T, 8>(p, t, fused, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Pass B: histogram, the two scans, the fill.
cudaError_t launch_transpose(const Params& p, const Transpose& t,
                             cudaStream_t stream) {
  const int HW = p.H * p.W;
  const size_t smem = (size_t)HW * sizeof(int);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(tile_histogram_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(fill_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  const dim3 tiles((unsigned)t.tiles, (unsigned)p.B);
  tile_histogram_kernel<<<tiles, kWarpsPerBlock * 32, smem, stream>>>(p, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int rows = p.B * HW;
  const int blocks = (rows + kScanThreads - 1) / kScanThreads;
  tile_scan_kernel<<<blocks, kScanThreads, 0, stream>>>(p.B, HW, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  row_offset_kernel<<<blocks, kScanThreads, 0, stream>>>(rows, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fill_kernel<<<tiles, 32, smem, stream>>>(p, t);
  return cudaGetLastError();
}

bool valid_shape(int B, int H, int W, int K) {
  return B >= 1 && H >= 1 && W >= 1 && K >= 1 && K <= 32 * kMaxSlotsPerLane;
}

// the transpose also needs its cursors in shared memory, int32 entry
// offsets, and global query indices that fit an entry's 23 upper bits
bool valid_transpose_shape(int B, int H, int W, int K) {
  return (long long)H * W <= kMaxKeyRows && max_entries(B, H, W, K) < (1ll << 31) &&
         (long long)B * H * W < (1ll << 23);
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

// Bytes of scratch the forward's tile schedule needs, 0 where it does not
// take the shape (then the forward runs the per-query kernel alone).
extern "C" long long epipolar_attention_forward_scratch_bytes(int B, int H, int W) {
  if (!tile_shape(B, H, W)) return 0;
  return (long long)carve_forward(nullptr, B, H, W, nullptr);
}

// `scratch` holds epipolar_attention_forward_scratch_bytes, or is null (the
// per-query kernel alone).  Its first two ints receive the tiles that took
// the tile path and the per-query path.
extern "C" int epipolar_attention_forward(
    const void* f1, const void* f2k, const void* f2v, const void* locs,
    const void* prior, void* out, void* depth, void* scratch, int B, int H,
    int W, int K, int C, int is_bf16, float scale, int use_sim, int softmax,
    int priormul, void* stream) {
  if (!valid_shape(B, H, W, K)) return (int)cudaErrorInvalidValue;
  if (scratch != nullptr && !tile_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  Params p = make_params(f1, f2k, f2v, locs, prior, B, H, W, K, scale,
                         use_sim, softmax, priormul);
  p.out = static_cast<float*>(out);
  p.depth = static_cast<float*>(depth);
  Schedule sch = {};
  if (scratch != nullptr) carve_forward(static_cast<char*>(scratch), B, H, W, &sch);
  const Schedule* tiles = scratch != nullptr ? &sch : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_forward<__nv_bfloat16>(p, tiles, C, s)
                       : launch_forward<float>(p, tiles, C, s));
}

// Bytes of scratch the backward needs: the tile schedule's where it takes
// the shape, and with key/value gradients the tile path's and the
// transpose's `partials` (1 when only one of dother1/dother2 is wanted or
// both go to one buffer, 2 when both are wanted apart) sets of partials; 0
// where neither applies.
extern "C" long long epipolar_attention_backward_scratch_bytes(
    int B, int H, int W, int K, int C, int partials) {
  return (long long)carve_backward(nullptr, B, H, W, K, C, partials, tile_shape(B, H, W),
                                   nullptr, nullptr, nullptr, nullptr);
}

// Whether the tile schedules take the shape (then both scratches begin with
// the tiles on the tile path and on the per-query path, two ints).
extern "C" int epipolar_attention_tile_shape(int B, int H, int W) {
  return tile_shape(B, H, W) ? 1 : 0;
}

// dother1 / dother2 may be null (no gradient wanted); when they are the same
// buffer it receives dother1 + dother2.  dprior (B, K, HW) may be null; it
// needs a prior.  Every row of every buffer given is written.  `scratch`
// holds epipolar_attention_backward_scratch_bytes; where the tile schedule
// takes the shape, its first two ints receive the tiles that took the tile
// path and the per-query path.  A tile whose union exceeds max_union rows
// (at most epipolar_attention_backward_max_union()) takes the per-query
// passes.
extern "C" int epipolar_attention_backward(
    const void* f1, const void* f2k, const void* f2v, const void* locs,
    const void* prior, const void* dout, void* dfeat1, void* dother1,
    void* dother2, void* dprior, void* scratch, int B, int H, int W, int K, int C,
    int is_bf16, float scale, int use_sim, int softmax, int priormul, int max_union,
    void* stream) {
  if (!valid_shape(B, H, W, K) || max_union < 0 || max_union > kBwdUnion)
    return (int)cudaErrorInvalidValue;
  const bool fused = dother1 != nullptr && dother1 == dother2;
  const bool kv = dother1 != nullptr || dother2 != nullptr;
  const bool tiles = tile_shape(B, H, W);
  if (kv && !valid_transpose_shape(B, H, W, K)) return (int)cudaErrorInvalidValue;
  if ((kv || tiles) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (dprior != nullptr && prior == nullptr) return (int)cudaErrorInvalidValue;
  Params p = make_params(f1, f2k, f2v, locs, prior, B, H, W, K, scale,
                         use_sim, softmax, priormul);
  p.dout = static_cast<const float*>(dout);
  p.dfeat1 = static_cast<float*>(dfeat1);
  p.dprior = static_cast<float*>(dprior);
  Transpose t = {};
  Schedule sch = {};
  TileGrads tg = {};
  t.d1 = static_cast<float*>(dother1);
  t.d2 = fused ? nullptr : static_cast<float*>(dother2);
  const int partials = !kv ? 0 : (t.d1 != nullptr && t.d2 != nullptr) ? 2 : 1;
  carve_backward(static_cast<char*>(scratch), B, H, W, K, C, partials, tiles, &p, &t, &sch, &tg);
  tg.fused = fused;
  tg.max_union = max_union;
  t.reduced = tiles;
  if (tiles) t.done = sch.done;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Schedule* plan = tiles ? &sch : nullptr;
  cudaError_t err = is_bf16 ? launch_backward<__nv_bfloat16>(p, plan, tg, C, s)
                            : launch_backward<float>(p, plan, tg, C, s);
  if (err != cudaSuccess || !kv) return (int)err;
  if ((err = launch_transpose(p, t, s)) != cudaSuccess) return (int)err;
  err = is_bf16 ? launch_gather<__nv_bfloat16>(p, t, C, fused, s)
                : launch_gather<float>(p, t, C, fused, s);
  if (err != cudaSuccess || !tiles) return (int)err;
  return (int)launch_reduce(p, tg, t, C, s);
}

extern "C" int epipolar_attention_max_samples() { return 32 * kMaxSlotsPerLane; }

extern "C" int epipolar_attention_max_key_rows() { return kMaxKeyRows; }

extern "C" int epipolar_attention_tile_queries() { return kTileQ; }

extern "C" int epipolar_attention_max_union() { return kMaxUnion; }

extern "C" int epipolar_attention_backward_max_union() { return kBwdUnion; }
