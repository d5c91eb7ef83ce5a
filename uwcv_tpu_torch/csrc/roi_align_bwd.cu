// Windowed RoIAlign backward: the gradient of the pooled output scattered
// back onto the level canvas.
//
// Replaces the XLA backward of the JAX package's pooler,
// uwcv_tpu/ops/roi_align.py::_pool_windows_bwd (the vjp of
// _pool_windows_xla, a scatter-add of back-interpolated window cotangents
// into a zero canvas).  For each roi r, with its window at
// (slab[r], y0[r], x0[r]) and the weights rounded to the gradient's type T
// as the forward rounds them (csrc/roi_align.cu):
//     d_rows[p, w, c]  = Σ_q wx[r, q, w] · g[r, p, q, c]
//     d_patch[h, w, c] = Σ_p wy[r, p, h] · d_rows[p, w, c]
//     dcanvas[slab, y0 + h, x0 + w, c] = Σ_{r covering it} d_patch_r[h, w, c]
// Both contractions and the sum over rois are taken in f32 and rounded to
// T once, when the cell is written.
//
// Bound: bytes.  The function reads g once and writes the dense canvas
// gradient once: at the training shapes (canvas [10, 200, 200, 256] in
// bf16, R = 64) that is 204.8 MB written against 1.6 MB (P=7) or 6.4 MB
// (P=14) of g.  The two contractions over the sub-windows are ~70 MFLOP
// (P=7) and ~180 MFLOP (P=14), a few microseconds of the f32 CUDA cores;
// mma.sync or wgmma would pad K = P (7 or 14) to 16 and the tile's columns
// to the fragment shapes and save none of the write stream, so the
// contractions stay on the CUDA cores.  With many more rois (R = 2 × 512)
// issuing those contractions tile by tile bounds the kernel instead
// (PERF.md).  chip_smoke.py::_roi_bwd_bound computes the bound and this
// design's floor (g read once per output tile a roi overlaps) from each
// run's rois.
//
// Design: owner computes; every output byte is written once, by one
// thread, with no atomic adds and no scratch canvas.
// - roi_bwd_tasks_kernel, one warp per roi, finds the nonzero rows of wy
//   and columns of wx after rounding to T (the union over p, as
//   subwindow_extent in ops/roi_align.py does) and writes one 16-byte task
//   per roi (slab, first row, first column, nh | nw << 16) and the weights
//   rounded to T and shifted to the sub-window; it also zeroes the tile
//   kernel's two work counters.
// - roi_bwd_tiles_kernel is persistent: as many blocks of 256 threads as
//   stay resident, each claiming its next piece of work from a counter
//   (atomicAdd, the next claim in flight during the current piece), so the
//   tiles that many rois overlap hold back no fixed share of the grid.
//   Each block marks in a shared-memory bitmap the 8×8-cell tiles that some
//   roi's sub-window overlaps (at the training shape 64 rois cover at most
//   16 % of the canvas, so most tiles are unmarked).  A marked tile is
//   summed in items of 64 bytes of channels (32 in bf16, 16 in f32), each
//   thread owning one 16-byte chunk of one cell and its f32 accumulator:
//   the block compacts the rois whose sub-window overlaps the tile into a
//   list in roi order (warp ballots and a prefix over the warps), and for
//   each copies g[r, :, :, channels], the task and the rounded weights into
//   shared memory with 16-byte cp.async, the next roi's copies in flight
//   while the current one is contracted over the bins that reach the tile:
//   d_rows for its columns (shared memory), then d_patch into the
//   accumulators.  The item ends with one 16-byte store a thread, rounded
//   to T.  An unmarked tile is written as zeros, each warp a whole cell
//   (all channels) at a time, four tiles a claim.  Half the blocks write
//   zeros first, so the write stream overlaps the items' waits.
// - Each cell sums its rois in index order with a fixed order of terms, so
//   two calls on the same inputs give bit-identical results.
// - C not a multiple of 8 (bf16) or 4 (f32), or an unaligned g, takes the
//   same kernel with element-wise loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

#include "ptx.cuh"

namespace {

constexpr int kWin = 32;          // largest window side
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;          // output tile side, cells
constexpr int kChunks = 4;        // 16-byte channel chunks of a cell's tile
constexpr int kStages = 2;        // rois in flight in a tile's pipeline
constexpr int kZeroClaim = 4;     // unmarked tiles claimed at a time
constexpr int kScanPer = 4;       // tasks a thread tests per scan
constexpr int kScan = kScanPer * kThreads;   // tasks per scan
constexpr int kMaxDevices = 64;   // devices tracked by tile_grid
constexpr int kMaxBitWords = 2048;  // tile bitmap: up to 65,536 tiles

static_assert(kTile * kTile * kChunks == kThreads, "one chunk a thread");

// Roi r's sub-window: its nonzero wy rows × wx columns, in slab coordinates.
struct alignas(16) RoiTask {
  int slab;
  int y;      // y0[r] + first nonzero row of wy
  int x;      // x0[r] + first nonzero column of wx
  int nhw;    // nh | nw << 16 (0 when every weight is zero)
};

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
  // the 4 floats of a 16-byte chunk
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
  // the 8 bf16 of a 16-byte chunk, widened exactly (low half first)
  static __device__ __forceinline__ void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&b);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

template <typename T, int P>
__global__ void __launch_bounds__(256)
roi_bwd_tasks_kernel(const int* __restrict__ slab, const int* __restrict__ y0,
                     const int* __restrict__ x0, const float* __restrict__ wy,
                     const float* __restrict__ wx,
                     RoiTask* __restrict__ tasks, T* __restrict__ weights,
                     int* __restrict__ next, int R, int win) {
  // the tile kernel's two work counters start at 0
  if (blockIdx.x == 0 && threadIdx.x < 2) next[threadIdx.x] = 0;
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  bool nzy = false, nzx = false;
  if (lane < win) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const size_t at = (static_cast<size_t>(r) * P + p) * win + lane;
      nzy |= Cvt<T>::to(Cvt<T>::from(wy[at])) != 0.0f;
      nzx |= Cvt<T>::to(Cvt<T>::from(wx[at])) != 0.0f;
    }
  }
  const unsigned my = __ballot_sync(~0u, nzy);
  const unsigned mx = __ballot_sync(~0u, nzx);
  const int hlo = my ? __ffs(my) - 1 : 0;
  const int wlo = mx ? __ffs(mx) - 1 : 0;
  const int nh = my ? 32 - __clz(my) - hlo : 0;
  const int nw = mx ? 32 - __clz(mx) - wlo : 0;
  // the weights rounded to T and shifted to the sub-window, zero beyond
  // it: wy rows [P][kWin], then wx rows [P][kWin]
  T* wb = weights + static_cast<size_t>(r) * 2 * P * kWin;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const size_t at = (static_cast<size_t>(r) * P + p) * win;
    wb[p * kWin + lane] = Cvt<T>::from(lane < nh ? wy[at + hlo + lane] : 0.0f);
    wb[(P + p) * kWin + lane] =
        Cvt<T>::from(lane < nw ? wx[at + wlo + lane] : 0.0f);
  }
  if (lane) return;
  RoiTask task;
  task.slab = slab[r];
  task.y = y0[r] + hlo;
  task.x = x0[r] + wlo;
  task.nhw = nh | (nw << 16);
  tasks[r] = task;
}

// Shared memory of a tile block (dynamic; the tile bitmap follows it).
template <typename T, int P>
struct alignas(16) TileSmem {
  static constexpr int kVec = 16 / sizeof(T);    // channels in a chunk
  static constexpr int kCt = kChunks * kVec;     // channels in a tile
  static constexpr int kWElems = 2 * P * kWin;   // weights of a roi
  uint4 g[kStages][P * P * kChunks];  // g[r, p, q, tile] of each roi
  // their rounded weights, [kWElems] of T each
  alignas(16) unsigned char w[kStages][kWElems * sizeof(T)];
  RoiTask task[kStages];
  float rows[P][kTile][kCt];          // d_rows of the tile's columns
  int list[kScan];                    // overlapping rois, in roi order
  int warp_hits[kScanPer * kWarps];
  int claim[2];                       // work claimed from a counter
};

// The rois among tasks[base, base + kScan) whose sub-window overlaps the
// tile (slab s, rows ty0.., columns tx0..), into sm.list in roi order: each
// thread loads its kScanPer tasks at once, then one ballot per warp and
// load.  → how many.
template <typename T, int P>
__device__ __forceinline__ int collect(TileSmem<T, P>& sm,
                                       const RoiTask* __restrict__ tasks,
                                       int base, int R, int s, int ty0,
                                       int tx0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool hit[kScanPer];
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    // task i = base + k·kThreads + tid, (slab, y, x, nhw) through the
    // read-only cache: a block tests the same tasks for each of its tiles
    const int i = base + k * kThreads + tid;
    int4 t = make_int4(-1, 0, 0, 0);
    if (i < R) t = __ldg(reinterpret_cast<const int4*>(tasks) + i);
    const int nh = t.w & 0xffff, nw = t.w >> 16;
    hit[k] = nh > 0 && nw > 0 && t.x == s && t.y < ty0 + kTile &&
             t.y + nh > ty0 && t.z < tx0 + kTile && t.z + nw > tx0;
  }
  unsigned m[kScanPer];
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    m[k] = __ballot_sync(~0u, hit[k]);
    if (lane == 0) sm.warp_hits[k * kWarps + warp] = __popc(m[k]);
  }
  __syncthreads();
  // hits before (load k, warp) in roi order: loads first, then warps
  int total = 0;
  int off[kScanPer];
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) off[k] = total;
      total += sm.warp_hits[k * kWarps + w];
    }
  }
#pragma unroll
  for (int k = 0; k < kScanPer; ++k)
    if (hit[k])
      sm.list[off[k] + __popc(m[k] & ((1u << lane) - 1u))] =
          base + k * kThreads + tid;
  __syncthreads();
  return total;
}

// Start the copies of listed roi t (its task, weights and g's channel tile
// c0..) into buffer b.  kVec16: 16-byte aligned rows of g, C % kVec == 0.
template <typename T, int P, bool kVec16>
__device__ __forceinline__ void fetch(TileSmem<T, P>& sm,
                                      const T* __restrict__ g,
                                      const RoiTask* __restrict__ tasks,
                                      const T* __restrict__ weights, int t,
                                      int b, int c0, int C) {
  using S = TileSmem<T, P>;
  const int tid = threadIdx.x;
  const int r = sm.list[t];
  if (tid == 0) uwcv::cp_async16(&sm.task[b], tasks + r, true);
  const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(
      weights + static_cast<size_t>(r) * S::kWElems);
  unsigned char* wdst = sm.w[b];
  constexpr int kWChunks = S::kWElems * sizeof(T) / 16;
  for (int k = tid; k < kWChunks; k += kThreads)
    uwcv::cp_async16(wdst + 16 * k, wsrc + 16 * k, true);
  const T* gr = g + static_cast<size_t>(r) * P * P * C;
  for (int k = tid; k < P * P * kChunks; k += kThreads) {
    const int c = c0 + (k % kChunks) * S::kVec;
    const T* src = gr + static_cast<size_t>(k / kChunks) * C + c;
    if constexpr (kVec16) {
      uwcv::cp_async16(&sm.g[b][k], c < C ? src : g, c < C);
    } else {
      T* dst = reinterpret_cast<T*>(&sm.g[b][k]);
#pragma unroll
      for (int e = 0; e < S::kVec; ++e)
        dst[e] = c + e < C ? src[e] : Cvt<T>::from(0.0f);
    }
  }
}

// Add buffer b's roi into the accumulators of this thread's chunk (cell
// (ti, tj) of the tile, chunk tk).  Ends with every thread past its reads
// of sm.rows' previous contents.
template <typename T, int P>
__device__ __forceinline__ void contract(TileSmem<T, P>& sm, int b, int ty0,
                                         int tx0, int ti, int tj, int tk,
                                         float* acc) {
  using S = TileSmem<T, P>;
  const int tid = threadIdx.x, lane = tid & 31;
  const RoiTask task = sm.task[b];
  const int nh = task.nhw & 0xffff, nw = task.nhw >> 16;
  // tile row i is row ty0 + i - task.y of the sub-window (and of its
  // shifted weights); likewise for columns
  const int hoff = ty0 - task.y, woff = tx0 - task.x;
  const T* swy = reinterpret_cast<const T*>(sm.w[b]);
  const T* swx = swy + P * kWin;

  // the bins p whose wy reaches the tile's rows and the bins q whose wx
  // reaches its columns (each warp finds them itself); the other terms are
  // products with zero weights
  bool py = false, qx = false;
  if (lane < P) {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int h = hoff + i, w = woff + i;
      py |= h >= 0 && h < nh && Cvt<T>::to(swy[lane * kWin + h]) != 0.0f;
      qx |= w >= 0 && w < nw && Cvt<T>::to(swx[lane * kWin + w]) != 0.0f;
    }
  }
  const unsigned mp = __ballot_sync(~0u, py), mq = __ballot_sync(~0u, qx);
  const int p_lo = mp ? __ffs(mp) - 1 : 0;
  const int p_n = mp ? 32 - __clz(mp) - p_lo : 0;
  const int q_lo = mq ? __ffs(mq) - 1 : 0;
  const int q_hi = mq ? 32 - __clz(mq) : 0;

  // stage 1: d_rows[p, j, c] = Σ_q wx[q, woff + j] · g[p, q, c] for those
  // p and the tile's columns j inside the sub-window
  for (int id = tid; id < p_n * kTile * kChunks; id += kThreads) {
    const int k = id % kChunks, j = (id / kChunks) % kTile;
    const int p = p_lo + id / (kChunks * kTile);
    const int w = woff + j;
    if (w < 0 || w >= nw) continue;
    float d[S::kVec] = {};
    for (int q = q_lo; q < q_hi; ++q) {
      const float a = Cvt<T>::to(swx[q * kWin + w]);
      float v[S::kVec];
      Cvt<T>::unpack(sm.g[b][(p * P + q) * kChunks + k], v);
#pragma unroll
      for (int e = 0; e < S::kVec; ++e) d[e] = fmaf(a, v[e], d[e]);
    }
    float4* dst = reinterpret_cast<float4*>(&sm.rows[p][j][k * S::kVec]);
#pragma unroll
    for (int e = 0; e < S::kVec / 4; ++e)
      dst[e] = make_float4(d[4 * e], d[4 * e + 1], d[4 * e + 2], d[4 * e + 3]);
  }
  __syncthreads();

  // stage 2: acc[c] += Σ_p wy[p, hoff + ti] · d_rows[p, tj, c]
  const int h = hoff + ti, w = woff + tj;
  if (h >= 0 && h < nh && w >= 0 && w < nw) {
    for (int p = p_lo; p < p_lo + p_n; ++p) {
      const float a = Cvt<T>::to(swy[p * kWin + h]);
      const float4* src =
          reinterpret_cast<const float4*>(&sm.rows[p][tj][tk * S::kVec]);
#pragma unroll
      for (int e = 0; e < S::kVec / 4; ++e) {
        const float4 v = src[e];
        acc[4 * e] = fmaf(a, v.x, acc[4 * e]);
        acc[4 * e + 1] = fmaf(a, v.y, acc[4 * e + 1]);
        acc[4 * e + 2] = fmaf(a, v.z, acc[4 * e + 2]);
        acc[4 * e + 3] = fmaf(a, v.w, acc[4 * e + 3]);
      }
    }
  }
}

// Sums the marked tile's rois into channel tile ct, then stores it: the
// roi list in chunks of kScan tasks, each roi's copies one roi ahead.
template <typename T, int P, bool kVec16>
__device__ __forceinline__ void sum_item(
    TileSmem<T, P>& sm, const T* __restrict__ g,
    const RoiTask* __restrict__ tasks, const T* __restrict__ weights,
    T* __restrict__ out, int R, int H, int W, int C, int s, int ty0, int tx0,
    int ct) {
  using Sm = TileSmem<T, P>;
  const int tid = threadIdx.x;
  // this thread's chunk: cell (ti, tj) of the tile, chunk tk of a tile's
  // channels; a warp covers one row of 8 cells
  const int tk = tid % kChunks, tj = tid / kChunks % kTile;
  const int ti = tid / (kChunks * kTile);
  const int c0 = ct * Sm::kCt;
  float acc[Sm::kVec] = {};
  for (int base = 0; base < R; base += kScan) {
    const int n = collect(sm, tasks, base, R, s, ty0, tx0);
    if (n == 0) continue;
    fetch<T, P, kVec16>(sm, g, tasks, weights, 0, 0, c0, C);
    uwcv::cp_async_commit();
    for (int t = 0; t < n; ++t) {
      if (t + 1 < n)
        fetch<T, P, kVec16>(sm, g, tasks, weights, t + 1, (t + 1) % kStages,
                            c0, C);
      uwcv::cp_async_commit();
      uwcv::cp_async_wait<kStages - 1>();
      __syncthreads();
      contract(sm, t % kStages, ty0, tx0, ti, tj, tk, acc);
      // buffer t % kStages and sm.rows are free again
      __syncthreads();
    }
  }
  if (ty0 + ti >= H || tx0 + tj >= W) return;
  T* cell = out + ((static_cast<size_t>(s) * H + ty0 + ti) * W + tx0 + tj) *
                      static_cast<size_t>(C);
  const int c = c0 + tk * Sm::kVec;
  if constexpr (kVec16) {
    if (c < C) *reinterpret_cast<uint4*>(cell + c) = Cvt<T>::pack(acc);
  } else {
#pragma unroll
    for (int e = 0; e < Sm::kVec; ++e)
      if (c + e < C) cell[c + e] = Cvt<T>::from(acc[e]);
  }
}

// Zeros into every channel of the tile's cells, each warp a whole cell.
template <typename T, bool kVec16>
__device__ __forceinline__ void zero_tile(T* __restrict__ out, int H, int W,
                                          int C, int s, int ty0, int tx0) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  for (int cell = threadIdx.x >> 5; cell < kTile * kTile; cell += kWarps) {
    const int y = ty0 + cell / kTile, x = tx0 + cell % kTile;
    if (y >= H || x >= W) continue;
    T* dst = out + ((static_cast<size_t>(s) * H + y) * W + x) *
                       static_cast<size_t>(C);
    if constexpr (kVec16) {
      for (int ch = lane; ch < C / kVec; ch += 32)
        reinterpret_cast<uint4*>(dst)[ch] = make_uint4(0, 0, 0, 0);
    } else {
      for (int c = lane; c < C; c += 32) dst[c] = Cvt<T>::from(0.0f);
    }
  }
}

// Persistent.  Each block first marks, in a bitmap of the spatial tiles in
// shared memory (bit_words words, then the counts of set bits before each
// word; none when the canvas has more than 32·kMaxBitWords tiles), the
// tiles that some roi's sub-window overlaps.  Then two passes, in an order
// that alternates with the block index: the items of the marked tiles,
// claimed one at a time from next[0] (M marked tiles · n_ct; item i is
// channel tile i % n_ct of the marked tile i / n_ct, so the channel tiles
// of one tile go to different blocks), and the zeros of the unmarked
// tiles, claimed kZeroClaim tiles at a time from next[1].
template <typename T, int P, bool kVec16>
__global__ void __launch_bounds__(kThreads)
roi_bwd_tiles_kernel(const T* __restrict__ g,
                     const RoiTask* __restrict__ tasks,
                     const T* __restrict__ weights, T* __restrict__ out,
                     int* __restrict__ next, int R, int S, int H, int W,
                     int C, int tiles_y, int tiles_x, int bit_words) {
  using Sm = TileSmem<T, P>;
  extern __shared__ __align__(16) unsigned char smem[];
  Sm& sm = *reinterpret_cast<Sm*>(smem);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + sizeof(Sm));
  int* before = reinterpret_cast<int*>(bits + bit_words);  // [bit_words + 1]
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_ct = (C + Sm::kCt - 1) / Sm::kCt;
  const int per_slab = tiles_y * tiles_x;
  const int n_tiles = S * per_slab;

  int marked = n_tiles;
  if (bit_words) {
    for (int i = tid; i < bit_words; i += kThreads) bits[i] = 0;
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(tasks) + r);
      const int nh = t.w & 0xffff, nw = t.w >> 16;
      if (nh == 0 || nw == 0 || t.x < 0 || t.x >= S) continue;
      const int ya = max(t.y, 0) / kTile, yb = min(t.y + nh - 1, H - 1) / kTile;
      const int xa = max(t.z, 0) / kTile, xb = min(t.z + nw - 1, W - 1) / kTile;
      for (int ty = ya; ty <= yb; ++ty)
        for (int tx = xa; tx <= xb; ++tx) {
          const int at = t.x * per_slab + ty * tiles_x + tx;
          atomicOr(&bits[at >> 5], 1u << (at & 31));
        }
    }
    __syncthreads();
    if (tid < 32) {
      int run = 0;
      for (int w0 = 0; w0 < bit_words; w0 += 32) {
        const int w = w0 + lane;
        const int n = w < bit_words ? __popc(bits[w]) : 0;
        int incl = n;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(~0u, incl, d);
          if (lane >= d) incl += v;
        }
        if (w < bit_words) before[w] = run + incl - n;
        run += __shfl_sync(~0u, incl, 31);
      }
      if (lane == 0) before[bit_words] = run;
    }
    __syncthreads();
    marked = before[bit_words];
  }

  for (int pass = 0; pass < 2; ++pass) {
    const bool sums = (pass == 0) == ((blockIdx.x & 1) == 0);
    if (!sums && !bit_words) continue;
    // claim work from counter next[0] (items) or next[1] (zero tiles,
    // kZeroClaim at a time), the next claim in flight during the work
    int* counter = next + (sums ? 0 : 1);
    const int step = sums ? 1 : kZeroClaim;
    const int end = sums ? marked * n_ct : n_tiles;
    if (tid == 0) sm.claim[0] = atomicAdd(counter, step);
    __syncthreads();
    int k = 0;
    for (int first = sm.claim[0]; first < end; ++k) {
      if (tid == 0) sm.claim[(k + 1) & 1] = atomicAdd(counter, step);
      if (sums) {
        const int rank = first / n_ct;
        int tile = rank;
        if (bit_words) {
          // the word holding the rank-th set bit, then the bit
          int lo = 0, hi = bit_words - 1;
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (before[mid] <= rank) lo = mid; else hi = mid - 1;
          }
          unsigned m = bits[lo];
          for (int j = rank - before[lo]; j > 0; --j) m &= m - 1;
          tile = lo * 32 + __ffs(m) - 1;
        }
        const int s = tile / per_slab, rem = tile - s * per_slab;
        sum_item<T, P, kVec16>(sm, g, tasks, weights, out, R, H, W, C, s,
                               rem / tiles_x * kTile, rem % tiles_x * kTile,
                               first - rank * n_ct);
      } else {
        for (int tile = first; tile < min(first + step, end); ++tile) {
          if (bits[tile >> 5] >> (tile & 31) & 1u) continue;
          const int s = tile / per_slab, rem = tile - s * per_slab;
          zero_tile<T, kVec16>(out, H, W, C, s, rem / tiles_x * kTile,
                               rem % tiles_x * kTile);
        }
      }
      __syncthreads();
      first = sm.claim[(k + 1) & 1];
    }
    __syncthreads();   // every thread has read its last claim
  }
}

// The tile kernel's grid on the current device: as many blocks as stay
// resident with smem bytes of dynamic shared memory, asked again only when
// the device or smem changes.
template <typename T, int P, bool kVec16>
cudaError_t tile_grid(int smem, int* blocks) {
  static std::mutex mu;
  static int seen_bytes[kMaxDevices], seen_blocks[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kMaxDevices && seen_blocks[dev] > 0 &&
      seen_bytes[dev] == smem) {
    *blocks = seen_blocks[dev];
    return cudaSuccess;
  }
  const auto kernel = roi_bwd_tiles_kernel<T, P, kVec16>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(TileSmem<T, P>)) + 8 * kMaxBitWords + 4);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (dev < kMaxDevices) {
    seen_bytes[dev] = smem;
    seen_blocks[dev] = *blocks;
  }
  return cudaSuccess;
}

template <typename T, int P, bool kVec16>
int launch_tiles(const T* g, const RoiTask* tasks, const T* weights, T* out,
                 int* next, int R, int S, int H, int W, int C, int tiles_y,
                 int tiles_x, cudaStream_t stream) {
  const long long tiles = static_cast<long long>(S) * tiles_y * tiles_x;
  const int bit_words =
      tiles <= 32LL * kMaxBitWords ? static_cast<int>((tiles + 31) / 32) : 0;
  // the block, then the bitmap and its prefix counts
  const int smem = static_cast<int>(sizeof(TileSmem<T, P>)) +
                   (bit_words ? 8 * bit_words + 4 : 0);
  int blocks = 0;
  const cudaError_t err = tile_grid<T, P, kVec16>(smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long most = tiles * ((C + TileSmem<T, P>::kCt - 1) /
                                  TileSmem<T, P>::kCt);
  roi_bwd_tiles_kernel<T, P, kVec16>
      <<<most < blocks ? static_cast<int>(most) : blocks, kThreads, smem,
         stream>>>(g, tasks, weights, out, next, R, S, H, W, C, tiles_y,
                   tiles_x, bit_words);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_p(const T* g, const int* slab, const int* y0, const int* x0,
             const float* wy, const float* wx, void* tasks, T* weights,
             T* out, int R, int S, int H, int W, int C, int win,
             cudaStream_t stream) {
  constexpr int kCt = TileSmem<T, P>::kCt;
  const int tiles_y = (H + kTile - 1) / kTile;
  const int tiles_x = (W + kTile - 1) / kTile;
  const long long items =
      static_cast<long long>(S) * tiles_y * tiles_x * ((C + kCt - 1) / kCt);
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  RoiTask* t = static_cast<RoiTask*>(tasks);
  int* next = reinterpret_cast<int*>(t + R);
  roi_bwd_tasks_kernel<T, P><<<(R + 7) / 8, 256, 0, stream>>>(
      slab, y0, x0, wy, wx, t, weights, next, R, win);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec16 = C % (16 / sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec16)
    return launch_tiles<T, P, true>(g, t, weights, out, next, R, S, H, W, C,
                                    tiles_y, tiles_x, stream);
  return launch_tiles<T, P, false>(g, t, weights, out, next, R, S, H, W, C,
                                   tiles_y, tiles_x, stream);
}

template <typename T>
int launch(const void* g, const void* slab, const void* y0, const void* x0,
           const void* wy, const void* wx, void* tasks, void* weights,
           void* dcanvas, int R, int P, int S, int H, int W, int C, int win,
           void* stream) {
  if (R <= 0) return 0;
  if (win <= 0 || win > kWin || win > H || win > W || C <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* gt = static_cast<const T*>(g);
  const int* sl = static_cast<const int*>(slab);
  const int* oy = static_cast<const int*>(y0);
  const int* ox = static_cast<const int*>(x0);
  const float* fy = static_cast<const float*>(wy);
  const float* fx = static_cast<const float*>(wx);
  T* wt = static_cast<T*>(weights);
  T* out = static_cast<T*>(dcanvas);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 7)
    return launch_p<T, 7>(gt, sl, oy, ox, fy, fx, tasks, wt, out, R, S, H, W,
                          C, win, s);
  if (P == 14)
    return launch_p<T, 14>(gt, sl, oy, ox, fy, fx, tasks, wt, out, R, S, H,
                           W, C, win, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Scratch from the caller, 16-byte aligned: tasks, 16 bytes a roi (4
// int32) and 16 more for the work counters; weights, 2·P·32 elements of
// g's type a roi.  dcanvas: the
// canvas gradient [S, H, W, C] in g's type; every element is written.
extern "C" int uwcv_roi_align_windows_bwd_f32(
    const void* g, const void* slab, const void* y0, const void* x0,
    const void* wy, const void* wx, void* tasks, void* weights,
    void* dcanvas, int R, int P, int S, int H, int W, int C, int window,
    void* stream) {
  return launch<float>(g, slab, y0, x0, wy, wx, tasks, weights, dcanvas, R,
                       P, S, H, W, C, window, stream);
}

extern "C" int uwcv_roi_align_windows_bwd_bf16(
    const void* g, const void* slab, const void* y0, const void* x0,
    const void* wy, const void* wx, void* tasks, void* weights,
    void* dcanvas, int R, int P, int S, int H, int W, int C, int window,
    void* stream) {
  return launch<__nv_bfloat16>(g, slab, y0, x0, wy, wx, tasks, weights,
                               dcanvas, R, P, S, H, W, C, window, stream);
}
