// The epilogue of each conv in the ResNet trunk in one pass: the FrozenBN
// affine y = x·scale + bias per channel, the optional residual (as it is,
// or under its own FrozenBN affine: the projection shortcut), and the
// ReLU, over a channels-last [N, H, W, C] activation.
//
// Replaces no TPU kernel.  The JAX package writes FrozenBN, the residual
// add and the ReLU as plain jnp ops (uwcv_tpu/models/resnet.py), which XLA
// fuses into the conv's output.  Eager PyTorch does not: the chain of
// ops/frozen_bn.py::frozen_bn_act_reference is two broadcast passes for the
// affine (on a channels-last tensor they take the legacy offset-computing
// elementwise kernel), then one for the add and one for the ReLU, and the
// same two again for a projection shortcut.
//
// Bound: bytes.  An element costs a few float operations; what must move
// is the conv output read once and the result written once (4 B an element
// in bfloat16), and the residual read once where there is one (6 B).  At the
// R50 trunk's shapes (batch 8, the 832×1024 canvas) that is 6.7 GB a
// forward, 2.0 ms at 3.35 TB/s.
//
// Design: a grid-stride loop over 16-byte vectors (8 bfloat16 or 4 float
// values of one pixel: C % 8 == 0, so a vector never spans two pixels),
// kUnroll vectors a thread in flight, neighbouring threads on neighbouring
// vectors.  The per-channel scale and bias are read as 16-byte vectors too,
// through the read-only cache: they are a few KB.  A thread's channel
// index moves by the grid's stride modulo the channel vectors, so the
// loop has no division.  No shared memory: nothing is reused.
//
// Rounding: bit-identical to the chain.  Each op of the chain computes in
// float and rounds its result to the tensor's dtype, so does this kernel,
// with explicitly rounded intrinsics (no FMA contraction):
//   t = rnd(x·s), u = rnd(t + b); the residual r' = r, or
//   rnd(rnd(r·s_r) + b_r); y = rnd(u + r'); ReLU: NaN stays, else max(y, 0).
// rnd is the round to bfloat16 (nearest even) in bfloat16 and the identity
// in float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 4;

enum Residual { kNone = 0, kIdentity = 1, kAffine = 2 };

// a 16-byte vector as float values and back, with the dtype's rounding
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 store(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float round(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const uint4& v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t bits(float v) {
    return static_cast<uint32_t>(
        __bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  __device__ __forceinline__ static uint4 store(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = bits(f[2 * k]) | (bits(f[2 * k + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// one vector of the epilogue: x (and r) at channel vector c
template <typename T, int kRes>
__device__ __forceinline__ uint4 epilogue(const uint4& xv, const uint4& rv,
                                          uint32_t c, const uint4* s,
                                          const uint4* b, const uint4* rs,
                                          const uint4* rb) {
  using V = Vec<T>;
  float x[V::kN], sc[V::kN], bi[V::kN];
  V::load(xv, x);
  V::load(__ldg(s + c), sc);
  V::load(__ldg(b + c), bi);
#pragma unroll
  for (int k = 0; k < V::kN; ++k)
    x[k] = V::round(__fadd_rn(V::round(__fmul_rn(x[k], sc[k])), bi[k]));
  if (kRes != kNone) {
    float r[V::kN];
    V::load(rv, r);
    if (kRes == kAffine) {
      V::load(__ldg(rs + c), sc);
      V::load(__ldg(rb + c), bi);
#pragma unroll
      for (int k = 0; k < V::kN; ++k)
        r[k] = V::round(__fadd_rn(V::round(__fmul_rn(r[k], sc[k])), bi[k]));
    }
#pragma unroll
    for (int k = 0; k < V::kN; ++k) x[k] = V::round(__fadd_rn(x[k], r[k]));
  }
#pragma unroll
  for (int k = 0; k < V::kN; ++k)
    x[k] = isnan(x[k]) ? x[k] : fmaxf(x[k], 0.0f);
  return V::store(x);
}

// n_vec vectors of x (and r) → out; c_vec channel vectors a pixel
template <typename T, int kRes>
__global__ void __launch_bounds__(kThreads)
    frozen_bn_act_kernel(const uint4* __restrict__ x,
                         const uint4* __restrict__ r,
                         const uint4* __restrict__ s,
                         const uint4* __restrict__ b,
                         const uint4* __restrict__ rs,
                         const uint4* __restrict__ rb,
                         uint4* __restrict__ out, uint32_t n_vec,
                         uint32_t c_vec) {
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint32_t step = stride % c_vec;
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t c = i % c_vec;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 xv[kUnroll], rv[kUnroll];
    uint32_t cv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      xv[k] = __ldg(x + i + k * stride);
      rv[k] = kRes != kNone ? __ldg(r + i + k * stride) : zero;
      cv[k] = c;
      c += step;
      if (c >= c_vec) c -= c_vec;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      out[i + k * stride] =
          epilogue<T, kRes>(xv[k], rv[k], cv[k], s, b, rs, rb);
  }
  for (; i < n_vec; i += stride) {
    const uint4 rv = kRes != kNone ? __ldg(r + i) : zero;
    out[i] = epilogue<T, kRes>(__ldg(x + i), rv, c, s, b, rs, rb);
    c += step;
    if (c >= c_vec) c -= c_vec;
  }
}

template <typename T, int kRes>
cudaError_t launch(const void* x, const void* r, const void* s, const void* b,
                   const void* rs, const void* rb, void* out, uint32_t n_vec,
                   uint32_t c_vec, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const uint32_t want = (n_vec + kThreads - 1) / kThreads;
  const uint32_t most = static_cast<uint32_t>(sms * kBlocksPerSm);
  const uint32_t blocks = want < most ? want : most;
  frozen_bn_act_kernel<T, kRes><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(r),
      static_cast<const uint4*>(s), static_cast<const uint4*>(b),
      static_cast<const uint4*>(rs), static_cast<const uint4*>(rb),
      static_cast<uint4*>(out), n_vec, c_vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* r, const void* s,
                     const void* b, const void* rs, const void* rb, void* out,
                     uint32_t n_vec, uint32_t c_vec, int residual,
                     cudaStream_t stream) {
  switch (residual) {
    case kNone: return launch<T, kNone>(x, r, s, b, rs, rb, out, n_vec, c_vec, stream);
    case kIdentity: return launch<T, kIdentity>(x, r, s, b, rs, rb, out, n_vec, c_vec, stream);
    case kAffine: return launch<T, kAffine>(x, r, s, b, rs, rb, out, n_vec, c_vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, residual (or null), scale, bias, residual scale and bias (or null),
// out: 16-byte aligned; n_vec 16-byte vectors in all (< 2^31), c_vec of
// them a pixel; residual 0 none, 1 as it is, 2 under its affine.
extern "C" int uwcv_frozen_bn_act(const void* x, const void* residual,
                                  const void* scale, const void* bias,
                                  const void* res_scale, const void* res_bias,
                                  void* out, int n_vec, int c_vec,
                                  int residual_mode, int bf16, void* stream) {
  if (n_vec <= 0 || c_vec <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t n = static_cast<uint32_t>(n_vec);
  const uint32_t c = static_cast<uint32_t>(c_vec);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(x, residual, scale, bias, res_scale,
                                     res_bias, out, n, c, residual_mode, s)
           : dispatch<float>(x, residual, scale, bias, res_scale, res_bias,
                             out, n, c, residual_mode, s);
  return static_cast<int>(err);
}
