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
// accumulated in f32, exactly the dtype discipline of the TPU kernel and
// of uwcv_tpu/ops/roi_align.py::_pool_windows_xla (rows rounded back to T
// between the two contractions).
//
// Design: one block per (roi, channel tile, tile of 7 output rows); one
// thread per channel.  The block stages its rows of wy and all of wx in
// shared memory, then walks the window column by column: a column's win
// values give the thread its 7 `rows` entries in registers, which fold at
// once into the 7×P output accumulators, so neither the window nor `rows`
// is ever written anywhere.  Neighbouring threads read neighbouring
// channels, so every load of a warp is one contiguous run of the NHWC
// canvas.
//
// Bound: bytes.  The least traffic is every canvas cell that some window
// covers, read once, plus the pooled [R, P, P, C] output written once
// (≈1.1 GB + 0.2 GB for the box pooler at batch 8, C=256, bf16); the two
// contractions are ~36 GFLOP, 0.04 ms at the bf16 tensor-core rate.  This
// first version reads each window from device memory (overlapping windows
// hit L2) and does its arithmetic on the CUDA cores; tensor cores and TMA
// window loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindow = 64;
constexpr int kRowTile = 7;
constexpr int kMaxThreads = 256;

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
__device__ __forceinline__ float round_to(float x) {
  return Cvt<T>::to(Cvt<T>::from(x));
}

template <typename T, int P>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_windows_kernel(const T* __restrict__ canvas,
                         const int* __restrict__ slab,
                         const int* __restrict__ y0,
                         const int* __restrict__ x0,
                         const float* __restrict__ wy,
                         const float* __restrict__ wx, T* __restrict__ out,
                         int H, int W, int C, int win) {
  __shared__ float swy[kRowTile][kMaxWindow];
  __shared__ float swx[P][kMaxWindow];

  const int r = blockIdx.x;
  const int p0 = blockIdx.z * kRowTile;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;

  for (int k = threadIdx.x; k < kRowTile * win; k += blockDim.x) {
    const int p = k / win, h = k % win;
    swy[p][h] = round_to<T>(wy[(static_cast<size_t>(r) * P + p0 + p) * win + h]);
  }
  for (int k = threadIdx.x; k < P * win; k += blockDim.x) {
    const int q = k / win, w = k % win;
    swx[q][w] = round_to<T>(wx[(static_cast<size_t>(r) * P + q) * win + w]);
  }
  __syncthreads();
  if (c >= C) return;

  const size_t row_stride = static_cast<size_t>(W) * C;
  const T* base = canvas +
                  ((static_cast<size_t>(slab[r]) * H + y0[r]) * W + x0[r]) * C + c;

  float acc[kRowTile][P];
#pragma unroll
  for (int p = 0; p < kRowTile; ++p)
#pragma unroll
    for (int q = 0; q < P; ++q) acc[p][q] = 0.0f;

  for (int w = 0; w < win; ++w) {
    const T* col = base + static_cast<size_t>(w) * C;
    float rows[kRowTile];
#pragma unroll
    for (int p = 0; p < kRowTile; ++p) rows[p] = 0.0f;
#pragma unroll 8
    for (int h = 0; h < win; ++h) {
      const float v = Cvt<T>::to(col[h * row_stride]);
#pragma unroll
      for (int p = 0; p < kRowTile; ++p) rows[p] = fmaf(swy[p][h], v, rows[p]);
    }
#pragma unroll
    for (int p = 0; p < kRowTile; ++p) {
      const float rp = round_to<T>(rows[p]);
#pragma unroll
      for (int q = 0; q < P; ++q) acc[p][q] = fmaf(swx[q][w], rp, acc[p][q]);
    }
  }

#pragma unroll
  for (int p = 0; p < kRowTile; ++p)
#pragma unroll
    for (int q = 0; q < P; ++q)
      out[((static_cast<size_t>(r) * P + p0 + p) * P + q) * C + c] =
          Cvt<T>::from(acc[p][q]);
}

template <typename T>
int launch(const void* canvas, const void* slab, const void* y0,
           const void* x0, const void* wy, const void* wx, void* out, int R,
           int P, int H, int W, int C, int win, void* stream) {
  if (R <= 0) return 0;
  if (win <= 0 || win > kMaxWindow || C <= 0 || P % kRowTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = C < kMaxThreads ? ((C + 31) / 32) * 32 : kMaxThreads;
  const dim3 grid(R, (C + threads - 1) / threads, P / kRowTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* cv = static_cast<const T*>(canvas);
  const int* sl = static_cast<const int*>(slab);
  const int* oy = static_cast<const int*>(y0);
  const int* ox = static_cast<const int*>(x0);
  const float* fy = static_cast<const float*>(wy);
  const float* fx = static_cast<const float*>(wx);
  T* o = static_cast<T*>(out);
  if (P == 7) {
    roi_align_windows_kernel<T, 7><<<grid, threads, 0, s>>>(cv, sl, oy, ox, fy, fx, o, H, W, C, win);
  } else if (P == 14) {
    roi_align_windows_kernel<T, 14><<<grid, threads, 0, s>>>(cv, sl, oy, ox, fy, fx, o, H, W, C, win);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int uwcv_roi_align_windows_f32(const void* canvas, const void* slab,
                                          const void* y0, const void* x0,
                                          const void* wy, const void* wx,
                                          void* out, int R, int P, int H,
                                          int W, int C, int window,
                                          void* stream) {
  return launch<float>(canvas, slab, y0, x0, wy, wx, out, R, P, H, W, C,
                       window, stream);
}

extern "C" int uwcv_roi_align_windows_bf16(const void* canvas, const void* slab,
                                           const void* y0, const void* x0,
                                           const void* wy, const void* wx,
                                           void* out, int R, int P, int H,
                                           int W, int C, int window,
                                           void* stream) {
  return launch<__nv_bfloat16>(canvas, slab, y0, x0, wy, wx, out, R, P, H, W,
                               C, window, stream);
}
