// Exact greedy NMS over score-sorted boxes, many problems in one launch.
//
// Replaces the TPU kernel uwcv_tpu/ops/pallas/nms_kernel.py
// (nms_greedy_pallas, body _nms_greedy_kernel): box j > i is cleared when i
// is still kept and IoU(i, j) > threshold; area = max(w,0)·max(h,0); IoU is
// 0 when the union is <= 0.
//
// Design: one block per problem.  The problem's boxes (16 B each) and keep
// flags live in shared memory; the block walks i = 0..N-1 and, when i is
// still kept, every thread clears its own j > i (j ≡ tid mod blockDim).
// A thread only ever writes the flags of its own j's, and every kept step
// ends in __syncthreads(), so the flag read at the top of step i is final
// for all threads and the branch is uniform.  Steps whose box was already
// suppressed cost one shared-memory read and no barrier.
//
// Bound: the N-step sequential dependency of greedy NMS (step i needs the
// outcome of every earlier step), not bytes — a problem reads 17 B a box
// and writes 1 B.  Problems run in parallel, one per SM.
//
// Rounding: every IoU operation uses an explicitly rounded intrinsic
// (__fadd_rn, __fmul_rn, __fdiv_rn), which nvcc never contracts into an
// FMA, so the keep mask matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__global__ void __launch_bounds__(kThreads)
nms_greedy_kernel(const float4* __restrict__ boxes,
                  const uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ keep, int n, float threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + n);
  uint8_t* skeep = reinterpret_cast<uint8_t*>(sarea + n);

  const int p = blockIdx.x;
  const float4* pb = boxes + static_cast<size_t>(p) * n;
  const uint8_t* pv = valid + static_cast<size_t>(p) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float4 b = pb[j];
    sbox[j] = b;
    sarea[j] = area_of(b);
    skeep[j] = pv[j] ? 1 : 0;
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    if (!skeep[i]) continue;  // uniform: skeep[i] is final (see header)
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    // first j > i owned by this thread
    const int t = static_cast<int>(threadIdx.x);
    const int bd = static_cast<int>(blockDim.x);
    int j = i + 1 + ((t - (i + 1)) % bd + bd) % bd;
    for (; j < n; j += bd) {
      if (!skeep[j]) continue;
      const float4 bj = sbox[j];
      const float iw = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(ai, sarea[j]), inter);
      const float iou = uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
      if (iou > threshold) skeep[j] = 0;
    }
    __syncthreads();
  }

  uint8_t* pk = keep + static_cast<size_t>(p) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) pk[j] = skeep[j];
}

}  // namespace

extern "C" int uwcv_nms_greedy(const void* boxes, const void* valid, void* keep,
                               int problems, int n, float threshold,
                               void* stream) {
  if (problems <= 0 || n <= 0) return 0;
  const size_t smem = static_cast<size_t>(n) * (sizeof(float4) + sizeof(float) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_greedy_kernel<<<problems, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, threshold);
  return static_cast<int>(cudaGetLastError());
}
