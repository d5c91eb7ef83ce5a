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
//     dcanvas[slab, y0 + h, x0 + w, c] += d_patch[h, w, c]
// Both contractions and the sum over rois are taken in f32; the caller
// zeroes the f32 canvas and casts it once to T afterwards.
//
// Bound: bytes.  The function reads g once and writes the canvas gradient
// once (mostly zeros); this design also writes the f32 scratch canvas
// (zeroed by the caller), reads and writes each sub-window cell once per
// roi with the atomics, and reads the scratch once more for the cast.  At
// the training shapes (canvas [10, 200, 200, 256], R = 64) the zeroing and
// the cast of the 409.6 MB scratch are most of that traffic;
// chip_smoke.py::_roi_bwd_bound computes both bounds from each run's rois
// (PERF.md gives them on an H100 at 3.35 TB/s).  The contractions are a few
// MFLOP.  Reading and writing the FPN levels in place, without the canvas,
// is the later fix (ROADMAP §B).
//
// Design, simple first:
// - one block of 256 threads per (roi, 16-channel tile), with g's tile
//   [P][P][16] and the roi's rounded weights staged in shared memory;
// - warp 0 finds the nonzero rows of wy and columns of wx (the union over
//   p, as subwindow_extent in ops/roi_align.py does), and only that
//   sub-window gets work: d_rows for its nw columns, then d_patch for its
//   nh × nw cells;
// - consecutive threads take consecutive channels, so each warp's atomics
//   cover two 64-byte runs of the canvas; a cell whose sum is exactly 0 is
//   not added (adding 0 changes nothing).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWin = 32;       // largest window side
constexpr int kThreads = 256;
constexpr int kCt = 16;        // channels a block covers

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and back, as the forward rounds its weights
template <typename T>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_kernel(const T* __restrict__ g, const int* __restrict__ slab,
                     const int* __restrict__ y0, const int* __restrict__ x0,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx,
                     float* __restrict__ dcanvas, int H, int W, int C,
                     int win, int tiles) {
  __shared__ float sg[P * P * kCt];         // g tile [p][q][c]
  __shared__ float srows[P * kWin * kCt];   // d_rows [p][w - wlo][c]
  __shared__ float swy[P * kWin];           // rounded weights [p][h]
  __shared__ float swx[P * kWin];           // rounded weights [q][w]
  __shared__ int sext[4];                   // hlo, nh, wlo, nw

  const int tid = threadIdx.x;
  const int r = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - r * tiles) * kCt;

  const float* wyr = wy + static_cast<size_t>(r) * P * win;
  const float* wxr = wx + static_cast<size_t>(r) * P * win;
  for (int i = tid; i < P * win; i += kThreads) {
    const int p = i / win, k = i - p * win;
    swy[p * kWin + k] = round_to<T>(wyr[i]);
    swx[p * kWin + k] = round_to<T>(wxr[i]);
  }
  const T* gr = g + static_cast<size_t>(r) * P * P * C;
  for (int i = tid; i < P * P * kCt; i += kThreads) {
    const int c = i % kCt, pq = i / kCt;
    sg[i] = c0 + c < C ? to_f32<T>(gr[static_cast<size_t>(pq) * C + c0 + c])
                       : 0.0f;
  }
  __syncthreads();

  if (tid < 32) {
    bool nzy = false, nzx = false;
    if (tid < win) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        nzy |= swy[p * kWin + tid] != 0.0f;
        nzx |= swx[p * kWin + tid] != 0.0f;
      }
    }
    const unsigned my = __ballot_sync(~0u, nzy);
    const unsigned mx = __ballot_sync(~0u, nzx);
    if (tid == 0) {
      sext[0] = my ? __ffs(my) - 1 : 0;
      sext[1] = my ? 32 - __clz(my) - sext[0] : 0;
      sext[2] = mx ? __ffs(mx) - 1 : 0;
      sext[3] = mx ? 32 - __clz(mx) - sext[2] : 0;
    }
  }
  __syncthreads();
  const int hlo = sext[0], nh = sext[1], wlo = sext[2], nw = sext[3];
  if (nh == 0 || nw == 0) return;

  // d_rows[p, w, c] = Σ_q wx[q, wlo + w] · g[p, q, c]
  for (int i = tid; i < P * nw * kCt; i += kThreads) {
    const int c = i % kCt, w = (i / kCt) % nw, p = i / (kCt * nw);
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < P; ++q)
      acc = fmaf(swx[q * kWin + wlo + w], sg[(p * P + q) * kCt + c], acc);
    srows[(p * kWin + w) * kCt + c] = acc;
  }
  __syncthreads();

  // d_patch[h, w, c] = Σ_p wy[p, hlo + h] · d_rows[p, w, c], added into
  // the canvas at (slab, y0 + hlo + h, x0 + wlo + w, c0 + c)
  const size_t base =
      ((static_cast<size_t>(slab[r]) * H + y0[r] + hlo) * W + x0[r] + wlo) *
          C + c0;
  for (int i = tid; i < nh * nw * kCt; i += kThreads) {
    const int c = i % kCt, w = (i / kCt) % nw, h = i / (kCt * nw);
    if (c0 + c >= C) continue;
    float acc = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p)
      acc = fmaf(swy[p * kWin + hlo + h], srows[(p * kWin + w) * kCt + c],
                 acc);
    if (acc != 0.0f)
      atomicAdd(dcanvas + base + (static_cast<size_t>(h) * W + w) * C + c,
                acc);
  }
}

template <typename T>
int launch(const void* g, const void* slab, const void* y0, const void* x0,
           const void* wy, const void* wx, void* dcanvas, int R, int P, int S,
           int H, int W, int C, int win, void* stream) {
  if (R <= 0) return 0;
  if (win <= 0 || win > kWin || win > H || win > W || C <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (C + kCt - 1) / kCt;
  const long long blocks = static_cast<long long>(R) * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const T* gt = static_cast<const T*>(g);
  const int* sl = static_cast<const int*>(slab);
  const int* oy = static_cast<const int*>(y0);
  const int* ox = static_cast<const int*>(x0);
  const float* fy = static_cast<const float*>(wy);
  const float* fx = static_cast<const float*>(wx);
  float* out = static_cast<float*>(dcanvas);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  if (P == 7) {
    roi_align_bwd_kernel<T, 7><<<nb, kThreads, 0, s>>>(
        gt, sl, oy, ox, fy, fx, out, H, W, C, win, tiles);
  } else if (P == 14) {
    roi_align_bwd_kernel<T, 14><<<nb, kThreads, 0, s>>>(
        gt, sl, oy, ox, fy, fx, out, H, W, C, win, tiles);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dcanvas: the caller's zeroed f32 canvas [S, H, W, C].
extern "C" int uwcv_roi_align_windows_bwd_f32(
    const void* g, const void* slab, const void* y0, const void* x0,
    const void* wy, const void* wx, void* dcanvas, int R, int P, int S,
    int H, int W, int C, int window, void* stream) {
  return launch<float>(g, slab, y0, x0, wy, wx, dcanvas, R, P, S, H, W, C,
                       window, stream);
}

extern "C" int uwcv_roi_align_windows_bwd_bf16(
    const void* g, const void* slab, const void* y0, const void* x0,
    const void* wy, const void* wx, void* dcanvas, int R, int P, int S,
    int H, int W, int C, int window, void* stream) {
  return launch<__nv_bfloat16>(g, slab, y0, x0, wy, wx, dcanvas, R, P, S, H,
                               W, C, window, stream);
}
