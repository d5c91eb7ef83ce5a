// Fused windowed RoIAlign forward (aligned=True, bin average folded into the
// interpolation weights).
//
// Replaces the TPU kernel uwcv_tpu/ops/pallas/roi_align_kernel.py
// (roi_align_windows_pallas, body _roi_align_kernel).  For each roi r it
// reads the window canvas[slab[r], y0[r]:y0[r]+win, x0[r]:x0[r]+win, :] and
// writes
//     rows[p, w, c] = round_T( Σ_h wy[r, p, h] · patch[h, w, c] )
//     out[r, p, q, c] = round_T( Σ_w wx[r, q, w] · rows[p, w, c] )
// with the weights rounded to the feature type T first and both sums
// accumulated in f32, the dtype discipline of the TPU kernel and of
// uwcv_tpu/ops/roi_align.py::_pool_windows_xla.
//
// Bound: bytes.  Only the cells where some weight of a roi is nonzero (its
// sub-window, ~15 % of a 32×32 window on proposal-like rois) reach the
// output.  The least traffic is every canvas cell that some roi's
// sub-window covers, read once, plus the pooled [R, P, P, C] output written
// once; chip_smoke.py::_roi_bound computes it from each run's rois (PERF.md
// gives it, for batch 8, C=256, bf16, on an H100 at 3.35 TB/s).  The two
// contractions over the sub-windows are a few GFLOP at P=7: negligible on
// the bf16 tensor cores, but not on the f32 CUDA cores.  Each roi's
// sub-window copied once is 0.63 GB at P=7 and 0.031 GB at P=14, against
// 4.19 GB and 0.21 GB of whole 32×32 windows (chip_smoke.py prints the
// sub-window bytes per case).
//
// Design, against those bytes and operations:
// - roi_tasks_kernel, one warp per roi, finds the first/last row h with a
//   nonzero wy[r,·,h] (rounded to T) and the same for columns in wx, and
//   writes one 16-byte task per roi (where the sub-window starts, its size)
//   and the roi's weights rounded to T and shifted to the sub-window (2 KB
//   in bf16).  A block of the main kernel then needs one load before its
//   copies start, and the blocks of one roi do not each re-read and round
//   the f32 weights.
// - roi_align_windows_kernel: one block of 4 warps per (roi, 32-byte
//   channel tile: 16 channels in bf16, 8 in f32), covering all P output
//   rows, so a window is read once at P=14 too.  The channel tiles of one
//   roi are neighbouring blocks and run together, so between them they
//   read whole canvas lines.  The block copies its weights and only the
//   sub-window (≤ 32×32 cells × 32 B = 32 KB, so ~5 blocks fit on an SM)
//   with 16-byte cp.async in two groups of 16 rows; the second group is in
//   flight while the first is contracted.  Cells
//   padded up to the 16-row / 16-column tensor-core tile are zero-filled
//   without reading the canvas.
// - bf16: both contractions on the tensor cores (mma.sync m16n8k16, f32
//   accumulate; P padded to the 16-row M tile).  Stage 1 is
//   rows[p,(w,c)] = wy[p,h]·patch[h,(w,c)] with K = h; its f32 fragments
//   are rounded to bf16 into shared memory, over the patch, which is dead by
//   then.  Stage 2 is out[p][q,c] = wx[q,w]·rows[p][w,c] with K = w.
//   Shared tiles are XOR-swizzled per 128-byte line so that the ldmatrix
//   reads of 8 rows and the fragment stores of 8 rows hit 8 bank groups.
// - f32 (the gate model): the same sub-window, contracted with FMAs on the
//   CUDA cores (no TF32, so f32 keeps its accuracy).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int kWin = 32;          // largest window (and sub-window) side
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCellBytes = 32;    // one (h, w) cell of a channel tile
constexpr int kChunks = kCellBytes / 16;
constexpr int kCellsPerLine = 128 / kCellBytes;
constexpr int kPatchBytes = kWin * kWin * kCellBytes;   // 32 KB
constexpr int kMRows = 16;        // P padded to the mma M tile
constexpr int kWStride = kWin + 8;  // weight row, padded against conflicts
constexpr int kMaxPairs = kWin / kWarps;  // n16 stage-1 tiles of a warp
constexpr int kMaxDevices = 64;   // devices tracked by allow_smem

// Where roi r's sub-window starts in the canvas, and its size.
struct alignas(16) RoiTask {
  int row0;   // canvas row slab·H + y0 + hlo (hlo: first nonzero row of wy)
  int col0;   // canvas column x0 + wlo (wlo: first nonzero column of wx)
  int nh;     // nonzero rows (0 when every weight is 0)
  int nw;     // nonzero columns
};

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <typename T>
constexpr int kSmemBytes = kPatchBytes + 2 * kMRows * kWStride * sizeof(T);

// Byte offset of 16-byte chunk j of cell (row, w) in a [row][kWin][32 B]
// shared tile.  A 128-byte line holds 4 cells; the chunk's slot in the line
// is XOR-ed with s.
__device__ __forceinline__ int cell_off(int row, int w, int j, int s) {
  return (row * (kWin / kCellsPerLine) + w / kCellsPerLine) * 128 +
         ((((w % kCellsPerLine) * kChunks + j) ^ s) << 4);
}

// The patch [h][w][chunk]: ldmatrix reads 8 consecutive h at one (w, j).
__device__ __forceinline__ int patch_off(int h, int w, int j) {
  return cell_off(h, w, j, h & 7);
}

// `rows` [p][w][chunk]: ldmatrix reads 8 consecutive w (two lines) at one
// (p, j); stage 1 stores 8 consecutive p at one (w, j).
__device__ __forceinline__ int rows_off(int p, int w, int j) {
  return cell_off(p, w, j, (p & 7) ^ ((w / kCellsPerLine) & 1));
}

// A operand of m16n8k16 from a [16][kWStride] bf16 weight tile, columns
// k0..k0+15 (k0 even).
__device__ __forceinline__ void load_a(const __nv_bfloat16* wt, int k0, int g,
                                       int t, uint32_t (&a)[4]) {
  const __nv_bfloat16* r0 = wt + g * kWStride + k0 + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * kWStride;
  a[0] = *reinterpret_cast<const uint32_t*>(r0);
  a[1] = *reinterpret_cast<const uint32_t*>(r1);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
}

__device__ __forceinline__ void store_bf16x2(void* dst, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
}

template <typename T, int P>
__global__ void __launch_bounds__(256)
roi_tasks_kernel(const int* __restrict__ slab, const int* __restrict__ y0,
                 const int* __restrict__ x0, const float* __restrict__ wy,
                 const float* __restrict__ wx, RoiTask* __restrict__ tasks,
                 T* __restrict__ weights, int R, int H, int win) {
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
  RoiTask task;
  task.nh = my ? 32 - __clz(my) - hlo : 0;
  task.nw = mx ? 32 - __clz(mx) - wlo : 0;
  // the weights rounded to T and shifted to the sub-window, zero outside
  // it and for p >= P: wy rows, then wx rows, kWin wide
  T* wb = weights + static_cast<size_t>(r) * 2 * kMRows * kWin;
#pragma unroll
  for (int p = 0; p < kMRows; ++p) {
    const size_t at = (static_cast<size_t>(r) * P + p) * win;
    const bool iy = p < P && lane < task.nh, ix = p < P && lane < task.nw;
    wb[p * kWin + lane] = Cvt<T>::from(iy ? wy[at + hlo + lane] : 0.0f);
    wb[(kMRows + p) * kWin + lane] =
        Cvt<T>::from(ix ? wx[at + wlo + lane] : 0.0f);
  }
  if (lane) return;
  task.row0 = slab[r] * H + y0[r] + hlo;
  task.col0 = x0[r] + wlo;
  tasks[r] = task;
}

template <int P>
__device__ __forceinline__ void contract_bf16(
    unsigned char* patch, const __nv_bfloat16* swy,
    const __nv_bfloat16* swx, __nv_bfloat16* out, int r, int c0, int C,
    int nh16, int nw16) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m = lane >> 3;          // ldmatrix matrix this lane addresses

  // stage 1: rows[p, (w, c)] = Σ_h wy[p, h] · patch[h, (w, c)], one n16
  // tile (both chunks of a cell) per column w
  float acc[kMaxPairs][2][4] = {};
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    if (kc == 0) {
      uwcv::cp_async_wait<1>();
    } else {
      uwcv::cp_async_wait<0>();
    }
    __syncthreads();
    if (kc * 16 >= nh16) continue;
    uint32_t a[4];
    load_a(swy, kc * 16, g, t, a);
    const int h = kc * 16 + (m & 1) * 8 + (lane & 7);
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int w = warp + kWarps * i;
      if (w < nw16) {
        uint32_t b[4];
        uwcv::ldmatrix_x4_trans(b, patch + patch_off(h, w, m >> 1));
        uwcv::mma_bf16_16816(acc[i][0], a, b[0], b[1]);
        uwcv::mma_bf16_16816(acc[i][1], a, b[2], b[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with the patch: `rows` replaces it

  unsigned char* rows = patch;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int w = warp + kWarps * i;
    if (w < nw16) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (g < P)
          store_bf16x2(rows + rows_off(g, w, j) + 4 * t, acc[i][j][0],
                       acc[i][j][1]);
        if (g + 8 < P)
          store_bf16x2(rows + rows_off(g + 8, w, j) + 4 * t, acc[i][j][2],
                       acc[i][j][3]);
      }
    }
  }
  __syncthreads();

  // stage 2: out[p][q, c] = Σ_w wx[q, w] · rows[p][w, c]
  uint32_t ax[2][4];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
    if (kc * 16 < nw16) load_a(swx, kc * 16, g, t, ax[kc]);
  const int w_lane = (m & 1) * 8 + (lane & 7);
  for (int p = warp; p < P; p += kWarps) {
    float o[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      if (kc * 16 < nw16) {
        uint32_t b[4];
        uwcv::ldmatrix_x4_trans(b, rows + rows_off(p, kc * 16 + w_lane, m >> 1));
        uwcv::mma_bf16_16816(o[0], ax[kc], b[0], b[1]);
        uwcv::mma_bf16_16816(o[1], ax[kc], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + j * 8 + 2 * t;
      if (c >= C) continue;
      __nv_bfloat16* dst = out + ((static_cast<size_t>(r) * P + p) * P) * C + c;
      if (g < P)
        store_bf16x2(dst + static_cast<size_t>(g) * C, o[j][0], o[j][1]);
      if (g + 8 < P)
        store_bf16x2(dst + static_cast<size_t>(g + 8) * C, o[j][2], o[j][3]);
    }
  }
}

template <int P>
__device__ __forceinline__ void contract_f32(unsigned char* patch,
                                             const float* swy,
                                             const float* swx, float* out,
                                             int r, int c0, int C, int nh,
                                             int nw) {
  constexpr int kCt = kCellBytes / sizeof(float);   // 8 channels
  constexpr int kItems = kWin * kCt / kThreads;     // (w, c) per thread
  const int tid = threadIdx.x;
  uwcv::cp_async_wait<0>();
  __syncthreads();

  // stage 1: each thread owns (w, c) cells and all P rows of them
  float acc[kItems][P] = {};
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int w = (tid + kThreads * i) / kCt, c = (tid + kThreads * i) % kCt;
    if (w >= nw) continue;
    for (int h = 0; h < nh; ++h) {
      const float v = *reinterpret_cast<const float*>(
          patch + patch_off(h, w, c >> 2) + 4 * (c & 3));
#pragma unroll
      for (int p = 0; p < P; ++p)
        acc[i][p] = fmaf(swy[p * kWStride + h], v, acc[i][p]);
    }
  }
  __syncthreads();  // `rows` replaces the patch

  unsigned char* rows = patch;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int w = (tid + kThreads * i) / kCt, c = (tid + kThreads * i) % kCt;
    if (w >= nw) continue;
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<float*>(rows + rows_off(p, w, c >> 2) + 4 * (c & 3)) =
          acc[i][p];
  }
  __syncthreads();

  // stage 2: each thread owns one (p, c) and all P columns q
  if (tid >= P * kCt) return;
  const int p = tid / kCt, c = tid % kCt;
  float o[P] = {};
  for (int w = 0; w < nw; ++w) {
    const float v = *reinterpret_cast<const float*>(
        rows + rows_off(p, w, c >> 2) + 4 * (c & 3));
#pragma unroll
    for (int q = 0; q < P; ++q) o[q] = fmaf(swx[q * kWStride + w], v, o[q]);
  }
  if (c0 + c >= C) return;
  float* dst = out + ((static_cast<size_t>(r) * P + p) * P) * C + c0 + c;
#pragma unroll
  for (int q = 0; q < P; ++q) dst[static_cast<size_t>(q) * C] = o[q];
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
roi_align_windows_kernel(const T* __restrict__ canvas,
                         const RoiTask* __restrict__ tasks,
                         const T* __restrict__ weights, T* __restrict__ out,
                         int W, int C, int tiles) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kPerChunk = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* patch = smem;
  T* swy = reinterpret_cast<T*>(smem + kPatchBytes);
  T* swx = swy + kMRows * kWStride;

  const int tid = threadIdx.x;
  const int r = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - r * tiles) * (kCellBytes / sizeof(T));
  const RoiTask task = tasks[r];
  // rows/columns copied: the tensor-core path pads to 16 with zeros
  const int nh_ld = kBf16 ? (task.nh + 15) & ~15 : task.nh;
  const int nw_ld = kBf16 ? (task.nw + 15) & ~15 : task.nw;

  // the task's weights (2 KB in bf16) join the first copy group
  constexpr int kWChunks = kWin * sizeof(T) / 16;   // 16-byte chunks a row
  const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(
      weights + static_cast<size_t>(r) * 2 * kMRows * kWin);
  for (int k = tid; k < 2 * kMRows * kWChunks; k += kThreads) {
    const int row = k / kWChunks, ch = k % kWChunks;
    uwcv::cp_async16(reinterpret_cast<unsigned char*>(swy) +
                         row * kWStride * sizeof(T) + 16 * ch,
                     wsrc + row * kWin * sizeof(T) + 16 * ch, true);
  }

  // each thread copies one (column w, chunk j) of every kRowStep-th row
  constexpr int kRowStep = kThreads / (kWin * kChunks);
  const int j = tid % kChunks, w = tid / kChunks % kWin;
  const bool col_ok = w < task.nw && c0 + j * kPerChunk < C;
  const size_t row_stride = static_cast<size_t>(W) * C;
  const T* src = canvas +
                 (static_cast<size_t>(task.row0) * W + task.col0 + w) * C +
                 c0 + j * kPerChunk;
#pragma unroll
  for (int grp = 0; grp < 2; ++grp) {
    const int h_end = min(nh_ld, 16 * (grp + 1));
    if (w < nw_ld) {
      for (int h = 16 * grp + tid / (kWin * kChunks); h < h_end;
           h += kRowStep) {
        const bool ok = col_ok && h < task.nh;
        uwcv::cp_async16(patch + patch_off(h, w, j),
                         ok ? src + h * row_stride : canvas, ok);
      }
    }
    uwcv::cp_async_commit();
  }

  if constexpr (kBf16) {
    contract_bf16<P>(patch, swy, swx, out, r, c0, C, nh_ld, nw_ld);
  } else {
    contract_f32<P>(patch, swy, swx, out, r, c0, C, task.nh, task.nw);
  }
}

// Allows the main kernel its dynamic shared memory on the current device,
// once per device and instantiation, not on every launch; a failure is
// returned and tried again at the next launch.
template <typename T, int P>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(roi_align_windows_kernel<T, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes<T>);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T, int P>
int launch_p(const T* canvas, const int* slab, const int* y0, const int* x0,
             const float* wy, const float* wx, void* tasks, T* weights, T* out,
             int R, int H, int W, int C, int win, cudaStream_t s) {
  const cudaError_t attr = allow_smem<T, P>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int kCt = kCellBytes / sizeof(T);
  const int tiles = (C + kCt - 1) / kCt;
  const long long blocks = static_cast<long long>(R) * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  RoiTask* t = static_cast<RoiTask*>(tasks);
  roi_tasks_kernel<T, P><<<(R + 7) / 8, 256, 0, s>>>(
      slab, y0, x0, wy, wx, t, weights, R, H, win);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  roi_align_windows_kernel<T, P><<<static_cast<int>(blocks), kThreads,
                                   kSmemBytes<T>, s>>>(canvas, t, weights,
                                                       out, W, C, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* canvas, const void* slab, const void* y0,
           const void* x0, const void* wy, const void* wx, void* tasks, void* weights, void* out, int R, int P, int H, int W,
           int C, int win, void* stream) {
  if (R <= 0) return 0;
  if (win <= 0 || win > kWin || win > H || win > W || C <= 0 || C % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* cv = static_cast<const T*>(canvas);
  const int* sl = static_cast<const int*>(slab);
  const int* oy = static_cast<const int*>(y0);
  const int* ox = static_cast<const int*>(x0);
  const float* fy = static_cast<const float*>(wy);
  const float* fx = static_cast<const float*>(wx);
  T* o = static_cast<T*>(out);
  T* wt = static_cast<T*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 7)
    return launch_p<T, 7>(cv, sl, oy, ox, fy, fx, tasks, wt, o, R, H, W, C,
                          win, s);
  if (P == 14)
    return launch_p<T, 14>(cv, sl, oy, ox, fy, fx, tasks, wt, o, R, H, W, C,
                           win, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Scratch from the caller, 16-byte aligned: tasks, 16 bytes a roi (4
// int32); weights, 2·16·32 elements of the canvas type a roi.
extern "C" int uwcv_roi_align_windows_f32(const void* canvas, const void* slab,
                                          const void* y0, const void* x0,
                                          const void* wy, const void* wx,
                                          void* tasks, void* weights,
                                          void* out, int R, int P, int H,
                                          int W, int C, int window,
                                          void* stream) {
  return launch<float>(canvas, slab, y0, x0, wy, wx, tasks, weights, out, R,
                       P, H, W, C, window, stream);
}

extern "C" int uwcv_roi_align_windows_bf16(const void* canvas,
                                           const void* slab, const void* y0,
                                           const void* x0, const void* wy,
                                           const void* wx, void* tasks,
                                           void* weights, void* out, int R,
                                           int P, int H, int W, int C,
                                           int window, void* stream) {
  return launch<__nv_bfloat16>(canvas, slab, y0, x0, wy, wx, tasks, weights,
                               out, R, P, H, W, C, window, stream);
}
