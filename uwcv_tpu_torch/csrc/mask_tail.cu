// The mask tail's canvas work in two kernels: paste every detection's
// cleaned head mask onto the canvas, give each pixel to the best-ranked
// kept detection that covers it, drop detections under the min-pixel
// count, and bit-pack each detection's canvas mask (MSB first), with no
// [B, D, H, W] stack in device memory.
//
// Replaces no TPU kernel.  The JAX package leaves this chain to XLA
// (uwcv_tpu/engine/predictor.py: paste_masks → remove_overlaps → the count
// filter → pack_bitmasks), which fuses its boolean traffic.  Eager PyTorch
// does not: the chain of ops/mask_paste.py::paste_claim_pack_reference
// writes and re-reads the whole stack at each step (a 1.36 GB float32
// product at B 8, D 50, 832×1024, then bool and uint8 stacks).
//
// Bound: bytes.  A pixel and detection cost a 2×2 bilinear sum and a few
// compares; what must move is the packed output, B·D·H·W/8 bytes (42.6 MB
// at the shapes above), and the head masks read once.  This design adds an
// owner map of B·H·W int16 (13.6 MB there), written once and read back
// only inside each detection's box, mostly from L2.
//
// Design:
// 1. claim_kernel: one block per (32×64 canvas tile, image).  The block
//    lists the kept detections whose pixel rectangle (where a paste weight
//    is nonzero, inside the image's true extent) meets the tile, ranks
//    them as torch.sort(-score, stable=True) does (score descending, ties
//    to the lower index), and walks them in rank order, 16 at a time: their
//    mask rows as bit words, and their row and column weights over the
//    tile, go to shared memory.  A thread holds 8 pixels of a row.  With
//    overlap removal the first detection whose pasted value is > 0.5 owns
//    the pixel (remove_overlaps' best-rank winner); the walk stops once
//    every pixel of the tile is owned.  Without it every covering
//    detection counts the pixel.  Counts are summed per block in shared
//    memory, then added with one global atomic per (block, detection); the
//    owner map gets the owner's index or -1.
// 2. pack_kernel: one block per (32-row band, detection, image).  The
//    final keep is keep && count >= min_pixels.  The block writes the
//    detection's rows of the packed output in the original detection
//    order, 16 bytes a thread: zeros outside its rectangle, inside it the
//    bits owner == d (or the pasted value again, without overlap removal).
//
// Rounding: the paste value is computed as the chain's matmuls round it.
// The axis weights follow ops/mask_paste.py::_axis_weights op by op with
// explicitly rounded intrinsics (no FMA contraction): u = ((p + 0.5 − lo)
// / span)·M − 0.5, clamped, floored; weights 1 − frac and frac on columns
// li and li + 1, zero where u lies outside [−1, M].  The wrapper computes
// lo and span = (hi − lo).clamp_min(1e-6) in the boxes' own dtype.  The
// head masks are 0/1, so the row product t_k = wa·m[li][k] + wb·m[li+1][k]
// is one rounded sum of the two weights at most, in any order; the column
// product is fma(t_{k+1}, wb_x, t_k·wa_x), the order in which cuBLAS's
// float32 GEMM accumulates k.  In bfloat16 the weights are rounded to
// bfloat16 first, and each product's result after its f32 sum, as the
// chain's bf16 matmuls round them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 32;       // mask rows are 32-bit words
constexpr int kMaxD = 1024;     // detections an image (shared-memory lists)
constexpr int kTileH = 32;      // claim tile: 8 threads a row, 8 pixels each
constexpr int kTileW = 64;
constexpr int kChunk = 16;      // detections whose tables a claim block holds
constexpr int kBand = 32;       // pack band: 8 threads a row
constexpr int kMargin = 2;      // pixels added around a rectangle
constexpr float kFar = 1048576.0f;   // beyond: the whole extent is searched
constexpr float kThreshold = 0.5f;

struct Axis {  // the two nonzero weights of a pixel, on columns li, li + 1
  int li;
  float wa, wb;
};

struct RowW {  // a row's weights and their rounded sum
  int li;
  float wa, wb, s;
};

struct Rect {  // inclusive pixel bounds; empty when y0 > y1 or x0 > x1
  int16_t y0, y1, x0, x1;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// _axis_weights at pixel p of an axis whose roi starts at lo and spans span
__device__ __forceinline__ Axis axis_weights(int p, float lo, float span,
                                             int m, bool bf16) {
  const float u = __fsub_rn(
      __fmul_rn(__fdiv_rn(__fsub_rn(__fadd_rn(static_cast<float>(p), 0.5f),
                                    lo),
                          span),
                static_cast<float>(m)),
      0.5f);
  Axis a{0, 0.0f, 0.0f};
  if (!(u >= -1.0f && u <= static_cast<float>(m))) return a;  // NaN too
  const float uc = fminf(fmaxf(u, 0.0f), static_cast<float>(m - 1));
  const float low = floorf(uc);
  const float frac = __fsub_rn(uc, low);
  a.li = static_cast<int>(low);
  a.wa = __fsub_rn(1.0f, frac);
  a.wb = frac;
  if (bf16) {
    a.wa = round_bf16(a.wa);
    a.wb = round_bf16(a.wb);
  }
  return a;
}

__device__ __forceinline__ RowW row_weights(int y, float lo, float span,
                                            int m, bool bf16) {
  const Axis a = axis_weights(y, lo, span, m, bf16);
  const float s = __fadd_rn(a.wa, a.wb);
  return RowW{a.li, a.wa, a.wb, bf16 ? round_bf16(s) : s};
}

// Entry (y, k) of the row product from the mask bits of rows li, li + 1
__device__ __forceinline__ float row_value(uint32_t a, uint32_t b, int k,
                                           const RowW& r) {
  const bool ba = (static_cast<uint64_t>(a) >> k) & 1;
  const bool bb = (static_cast<uint64_t>(b) >> k) & 1;
  return ba ? (bb ? r.s : r.wa) : (bb ? r.wb : 0.0f);
}

__device__ __forceinline__ bool pasted(uint32_t a, uint32_t b,
                                       const RowW& r, const Axis& c,
                                       bool bf16) {
  const float t0 = row_value(a, b, c.li, r);
  const float t1 = row_value(a, b, c.li + 1, r);
  float v = __fmaf_rn(t1, c.wb, __fmul_rn(t0, c.wa));
  if (bf16) v = round_bf16(v);
  return v > kThreshold;
}

// Pixels p of [0, n) where -1 <= u(p) <= m, widened by kMargin (the
// rounding of u moves a bound by far less than a pixel)
__device__ __forceinline__ void axis_range(float lo, float span, int m,
                                           int n, int16_t& p0, int16_t& p1) {
  int a = 0, b = n - 1;
  if (isfinite(lo) && isfinite(span) && fabsf(lo) < kFar && span < kFar) {
    const double dl = lo, ds = span;
    const double first = dl - 0.5 * ds / m - 0.5;
    const double last = dl + ds * (m + 0.5) / m - 0.5;
    a = max(a, static_cast<int>(floor(first)) - kMargin);
    b = min(b, static_cast<int>(ceil(last)) + kMargin);
  }
  p0 = static_cast<int16_t>(min(a, n));
  p1 = static_cast<int16_t>(max(b, -1));
}

// geo = (x lo, y lo, x span, y span); eh, ew: the image's true extent
__device__ __forceinline__ Rect det_rect(float4 g, int m, int eh, int ew) {
  Rect r;
  axis_range(g.y, g.w, m, eh, r.y0, r.y1);
  axis_range(g.x, g.z, m, ew, r.x0, r.x1);
  return r;
}

// Does detection e (score t) rank before d (score s)?  A strict total
// order: score descending, NaN last, ties to the lower index.
__device__ __forceinline__ bool ranks_before(float t, int e, float s,
                                             int d) {
  if (isnan(t) || isnan(s)) return isnan(t) == isnan(s) ? e < d : isnan(s);
  return t > s || (t == s && e < d);
}

__device__ __forceinline__ void extent_of(const int* out_sizes, int b,
                                          int h, int w, int& eh, int& ew) {
  eh = max(min(out_sizes[2 * b], h), 0);
  ew = max(min(out_sizes[2 * b + 1], w), 0);
}

// Mask rows of one detection as bit words, by one warp: words[m] = 0
__device__ __forceinline__ void mask_words(const uint8_t* mask, int m,
                                           uint32_t* words, int lane) {
  for (int r = 0; r < m; ++r) {
    const uint32_t word = __ballot_sync(~0u, lane < m && mask[r * m + lane]);
    if (lane == 0) words[r] = word;
  }
  if (lane == 0) words[m] = 0;
}

__global__ void __launch_bounds__(kThreads)
claim_kernel(const uint8_t* __restrict__ masks,
             const float4* __restrict__ geo, const uint8_t* __restrict__ keep,
             const float* __restrict__ scores,
             const int* __restrict__ out_sizes, int* __restrict__ counts,
             int16_t* __restrict__ owner, int n_det, int m, int h, int w,
             bool overlaps, bool bf16) {
  __shared__ int16_t s_found[kMaxD];   // detections meeting the tile
  __shared__ float s_key[kMaxD];       // their scores
  __shared__ int16_t s_det[kMaxD];     // the same in rank order
  __shared__ Rect s_rect[kMaxD];
  __shared__ int s_count[kMaxD];
  __shared__ int s_n;
  __shared__ uint32_t s_words[kChunk][kMaxM + 1];
  __shared__ RowW s_rows[kChunk][kTileH];
  __shared__ Axis s_cols[kChunk][kTileW];

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t det0 = static_cast<size_t>(b) * n_det;
  int eh, ew;
  extent_of(out_sizes, b, h, w, eh, ew);
  if (tid == 0) s_n = 0;
  __syncthreads();

  // 1. the kept detections whose rectangle meets the tile
  for (int d = tid; d < n_det; d += kThreads) {
    if (!keep[det0 + d]) continue;
    const Rect r = det_rect(geo[det0 + d], m, eh, ew);
    if (r.y0 <= r.y1 && r.x0 <= r.x1 && r.y0 < ty0 + kTileH &&
        r.y1 >= ty0 && r.x0 < tx0 + kTileW && r.x1 >= tx0) {
      const int i = atomicAdd(&s_n, 1);
      s_found[i] = static_cast<int16_t>(d);
      s_key[i] = scores[det0 + d];
    }
  }
  __syncthreads();
  const int n = s_n;

  // 2. their ranks among themselves
  for (int i = tid; i < n; i += kThreads) {
    const int d = s_found[i];
    const float s = s_key[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += ranks_before(s_key[j], s_found[j], s, d);
    s_det[rank] = static_cast<int16_t>(d);
    s_rect[rank] = det_rect(geo[det0 + d], m, eh, ew);
    s_count[rank] = 0;
  }

  // 3. the walk in rank order, kChunk detections at a time
  const int row = tid / 8, y = ty0 + row, col = (tid % 8) * 8;
  const int x0 = tx0 + col;
  uint32_t pending = 0;      // pixels in the extent and not yet owned
  if (y < eh) {
    for (int i = 0; i < 8; ++i) pending |= (x0 + i < ew ? 1u : 0u) << i;
  }
  int16_t own[8];
  for (int i = 0; i < 8; ++i) own[i] = -1;
  for (int base = 0; base < n; base += kChunk) {
    const int nc = min(kChunk, n - base);
    __syncthreads();   // the ranks are written; the last chunk is done
    for (int e = warp; e < nc; e += kWarps) {
      mask_words(masks + (det0 + s_det[base + e]) * m * m, m, s_words[e],
                 lane);
    }
    for (int i = tid; i < nc * kTileH; i += kThreads) {
      const int e = i / kTileH, r = i % kTileH;
      const float4 g = geo[det0 + s_det[base + e]];
      s_rows[e][r] = row_weights(ty0 + r, g.y, g.w, m, bf16);
    }
    for (int i = tid; i < nc * kTileW; i += kThreads) {
      const int e = i / kTileW, c = i % kTileW;
      const float4 g = geo[det0 + s_det[base + e]];
      s_cols[e][c] = axis_weights(tx0 + c, g.x, g.z, m, bf16);
    }
    __syncthreads();
    for (int e = 0; e < nc && pending; ++e) {
      const Rect r = s_rect[base + e];
      if (y < r.y0 || y > r.y1 || x0 + 7 < r.x0 || x0 > r.x1) continue;
      const RowW rw = s_rows[e][row];
      const uint32_t wa = s_words[e][rw.li], wb = s_words[e][rw.li + 1];
      uint32_t hit = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if ((pending >> i) & 1) {
          hit |= (pasted(wa, wb, rw, s_cols[e][col + i], bf16) ? 1u : 0u)
                 << i;
        }
      }
      if (hit) {
        atomicAdd(&s_count[base + e], __popc(hit));
        if (overlaps) {
          pending &= ~hit;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if ((hit >> i) & 1) own[i] = s_det[base + e];
          }
        }
      }
    }
    // every pixel owned: no later detection can claim one
    const bool more = __syncthreads_or(pending != 0);
    if (overlaps && !more) break;
  }
  __syncthreads();

  // 4. the owner map and the counts
  if (overlaps && y < h && x0 < w) {   // w % 8 == 0: all 8 on the canvas
    uint4 v;
    uint32_t* p = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = static_cast<uint16_t>(own[2 * i]) |
             (static_cast<uint32_t>(static_cast<uint16_t>(own[2 * i + 1]))
              << 16);
    }
    *reinterpret_cast<uint4*>(
        owner + (static_cast<size_t>(b) * h + y) * w + x0) = v;
  }
  for (int i = tid; i < n; i += kThreads) {
    if (s_count[i]) atomicAdd(&counts[det0 + s_det[i]], s_count[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint8_t* __restrict__ masks,
            const float4* __restrict__ geo, const uint8_t* __restrict__ keep,
            const int* __restrict__ out_sizes,
            const int* __restrict__ counts,
            const int16_t* __restrict__ owner, uint8_t* __restrict__ packed,
            uint8_t* __restrict__ keep_out, int n_det, int m, int h, int w,
            int min_pixels, bool overlaps, bool bf16) {
  __shared__ uint32_t s_words[kMaxM + 1];
  const int d = blockIdx.y, b = blockIdx.z;
  const size_t bd = static_cast<size_t>(b) * n_det + d;
  const bool kept = keep[bd] && counts[bd] >= min_pixels;
  if (blockIdx.x == 0 && threadIdx.x == 0) keep_out[bd] = kept;
  int eh, ew;
  extent_of(out_sizes, b, h, w, eh, ew);
  const float4 g = geo[bd];
  Rect r{0, -1, 0, -1};
  if (kept) r = det_rect(g, m, eh, ew);
  if (kept && !overlaps && threadIdx.x < 32) {
    mask_words(masks + bd * m * m, m, s_words, threadIdx.x);
  }
  __syncthreads();

  const int y = blockIdx.x * kBand + threadIdx.x / 8;
  if (y >= h) return;
  const int row_bytes = w / 8;
  uint8_t* out = packed + (bd * h + y) * row_bytes;
  const bool in_rows = y >= r.y0 && y <= r.y1;
  RowW rw{0, 0.0f, 0.0f, 0.0f};
  uint32_t wa = 0, wb = 0;
  if (in_rows && !overlaps) {
    rw = row_weights(y, g.y, g.w, m, bf16);
    wa = s_words[rw.li];
    wb = s_words[rw.li + 1];
  }
  const int16_t* own = owner + (static_cast<size_t>(b) * h + y) * w;
  // byte j of the row: pixels 8j .. 8j + 7, the first in the top bit
  auto pack8 = [&](int j) -> uint32_t {
    const int x0 = 8 * j;
    if (!in_rows || x0 + 7 < r.x0 || x0 > r.x1) return 0;
    uint32_t byte = 0;
    if (overlaps) {
      const uint4 v = *reinterpret_cast<const uint4*>(own + x0);
      const int16_t* o = reinterpret_cast<const int16_t*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) byte |= (o[i] == d ? 1u : 0u) << (7 - i);
    } else {
      for (int i = 0; i < 8; ++i) {
        const int x = x0 + i;
        if (x < r.x0 || x > r.x1) continue;
        const Axis c = axis_weights(x, g.x, g.z, m, bf16);
        byte |= (pasted(wa, wb, rw, c, bf16) ? 1u : 0u) << (7 - i);
      }
    }
    return byte;
  };
  if (row_bytes % 16 == 0) {
    for (int c = threadIdx.x % 8; c < row_bytes / 16; c += 8) {
      uint4 v = make_uint4(0, 0, 0, 0);
      const int x0 = 128 * c;
      if (in_rows && x0 + 127 >= r.x0 && x0 <= r.x1) {
        uint32_t* p = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 16 * c + 4 * q;
          p[q] = pack8(j) | (pack8(j + 1) << 8) | (pack8(j + 2) << 16) |
                 (pack8(j + 3) << 24);
        }
      }
      *reinterpret_cast<uint4*>(out + 16 * c) = v;
    }
  } else {
    for (int j = threadIdx.x % 8; j < row_bytes; j += 8) {
      out[j] = static_cast<uint8_t>(pack8(j));
    }
  }
}

}  // namespace

// masks [B, D, M, M] uint8 0/1; geo [B, D, 4] f32 (x lo, y lo, x span,
// y span); keep [B, D] uint8; scores [B, D] f32; out_sizes [B, 2] int32;
// counts [B, D] int32, zeroed; owner [B, H, W] int16 scratch (unused
// without overlap removal); packed [B, D, H, W/8] uint8 and keep_out
// [B, D] uint8 written.  W % 8 == 0, M <= 32, D <= 1024, H and W < 32768.
extern "C" int uwcv_paste_claim_pack(const void* masks, const void* geo,
                                     const void* keep, const void* scores,
                                     const void* out_sizes, void* counts,
                                     void* owner, void* packed,
                                     void* keep_out, int b, int d, int m,
                                     int h, int w, int min_pixels,
                                     int overlaps, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 claim_grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                        b);
  claim_kernel<<<claim_grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(masks), static_cast<const float4*>(geo),
      static_cast<const uint8_t*>(keep), static_cast<const float*>(scores),
      static_cast<const int*>(out_sizes), static_cast<int*>(counts),
      static_cast<int16_t*>(owner), d, m, h, w, overlaps != 0, bf16 != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pack_grid((h + kBand - 1) / kBand, d, b);
  pack_kernel<<<pack_grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(masks), static_cast<const float4*>(geo),
      static_cast<const uint8_t*>(keep), static_cast<const int*>(out_sizes),
      static_cast<const int*>(counts), static_cast<const int16_t*>(owner),
      static_cast<uint8_t*>(packed), static_cast<uint8_t*>(keep_out), d, m,
      h, w, min_pixels, overlaps != 0, bf16 != 0);
  return static_cast<int>(cudaGetLastError());
}
