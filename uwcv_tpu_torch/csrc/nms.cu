// Exact greedy NMS over score-sorted boxes, many problems in one call.
//
// Replaces the TPU kernel uwcv_tpu/ops/pallas/nms_kernel.py
// (nms_greedy_pallas, body _nms_greedy_kernel): box j > i is cleared when i
// is still kept and IoU(i, j) > threshold; area = max(w,0)·max(h,0); IoU is
// 0 when the union is <= 0.  Invalid boxes are never kept and never
// suppress.
//
// Design: a bit matrix, then a scan.
// 1. nms_mask_kernel: grid (64-column block, 64-row block, problem) over
//    the upper triangle, one thread per row i.  A thread tests its box i
//    against the 64 boxes j > i of its column block and writes one uint64
//    word of `IoU(i, j) > threshold` bits into mask[problem, i, block]
//    (scratch [P, N, ceil(N/64)] from the wrapper: 5.1 MB for the RPN's 40
//    problems of 1000, which stays in L2).  This phase uses all SMs.
// 2. nms_scan_kernel: one warp per problem walks the 64-box blocks in
//    order.  Block k's `removed` word is ~valid OR word k of every box
//    kept in earlier blocks (a list in shared memory); those loads, and
//    the block's 64 diagonal words mask[i, k], are spread over the lanes
//    and issued while block k - 1 is walked.  The walk takes the block's
//    undecided boxes lowest first: such an i is kept, and its diagonal
//    word, fetched by a warp shuffle, is OR-ed into `removed`.  j is
//    cleared iff some kept i < j has IoU > threshold, so the result is the
//    greedy one by construction.  There is no block barrier, only warp
//    shuffles: the sequential dependency is N warp steps per problem, of
//    which only kept boxes cost more than a bit test.
//
// Bound: that sequential dependency, not bytes (a problem reads 17 B a box
// and writes 1 B) nor operations (~13 f32 operations an IoU test).
//
// Rounding: every IoU operation uses an explicitly rounded intrinsic
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn), which nvcc never contracts
// into an FMA, in the plain version's order, so the keep mask matches the
// plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 64;                 // boxes per word, row and column block
constexpr int kMaxWords = 128;            // NMS_MAX_N / 64
constexpr int kAhead = 8;                 // kept-row words a lane prefetches

typedef unsigned long long u64;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ bool over(float4 bi, float ai, float4 bj, float aj,
                                     float threshold) {
  const float iw = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
  // no intersection: the quotient is exactly 0, so skip the division
  const float iou = inter > 0.0f && uni > 0.0f
                        ? __fdiv_rn(inter, fmaxf(uni, 1e-12f))
                        : 0.0f;
  return iou > threshold;
}

__global__ void __launch_bounds__(kBits)
nms_mask_kernel(const float4* __restrict__ boxes, u64* __restrict__ mask,
                int n, int words, float threshold) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;  // below the diagonal: never read by the scan
  __shared__ float4 sbox[kBits];
  __shared__ float sarea[kBits];
  const float4* pb = boxes + static_cast<size_t>(blockIdx.z) * n;
  const int j0 = cb * kBits;
  const int nj = min(kBits, n - j0);
  if (static_cast<int>(threadIdx.x) < nj) {
    const float4 b = pb[j0 + threadIdx.x];
    sbox[threadIdx.x] = b;
    sarea[threadIdx.x] = area_of(b);
  }
  __syncthreads();
  const int i = rb * kBits + threadIdx.x;
  if (i >= n) return;
  const float4 bi = pb[i];
  const float ai = area_of(bi);
  u64 bits = 0;
  for (int k = cb == rb ? threadIdx.x + 1 : 0; k < nj; ++k)
    if (over(bi, ai, sbox[k], sarea[k], threshold)) bits |= 1ull << k;
  mask[(static_cast<size_t>(blockIdx.z) * n + i) * words + cb] = bits;
}

__device__ __forceinline__ u64 shfl64(u64 v, int lane) {
  const unsigned lo = __shfl_sync(~0u, static_cast<unsigned>(v), lane);
  const unsigned hi = __shfl_sync(~0u, static_cast<unsigned>(v >> 32), lane);
  return (static_cast<u64>(hi) << 32) | lo;
}

__device__ __forceinline__ u64 or_reduce(u64 v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v |= __shfl_xor_sync(~0u, v, d);
  return v;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int n, int words) {
  // indices of the boxes kept so far, in order
  __shared__ int kept_list[kMaxWords * kBits];
  const int lane = threadIdx.x;
  const size_t p = blockIdx.x;
  const uint8_t* pv = valid + p * n;
  uint8_t* pk = keep + p * n;
  const u64* pm = mask + p * n * words;
  auto word = [&](int i, int k) -> u64 {
    return i < n ? pm[static_cast<size_t>(i) * words + k] : 0ull;
  };
  auto flag = [&](int i) -> bool { return i < n && pv[i]; };

  // block 0: its diagonal words and valid flags; no box is kept yet
  u64 d0 = word(lane, 0), d1 = word(lane + 32, 0);
  bool f0 = flag(lane), f1 = flag(lane + 32);
  u64 col = 0;  // this lane's share of the OR of earlier kept rows
  int n_kept = 0;

  for (int k = 0; k < words; ++k) {
    const int i0 = k * kBits + lane;
    // loads for block k + 1, in flight during this block's walk: its
    // diagonal words and valid flags, word k + 1 of the rows kept before
    // this block, and word k + 1 of this block's own rows
    const int i1 = i0 + kBits;
    const bool more = k + 1 < words;
    const u64 nd0 = more ? word(i1, k + 1) : 0ull;
    const u64 nd1 = more ? word(i1 + 32, k + 1) : 0ull;
    const bool nf0 = more && flag(i1), nf1 = more && flag(i1 + 32);
    // the first kAhead·32 kept rows are loaded into registers now and
    // OR-ed after the walk; the rest (rare) after the walk
    u64 ahead[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int x = lane + 32 * u;
      ahead[u] = more && x < n_kept
                     ? pm[static_cast<size_t>(kept_list[x]) * words + k + 1]
                     : 0ull;
    }
    const u64 own0 = more ? word(i0, k + 1) : 0ull;
    const u64 own1 = more ? word(i0 + 32, k + 1) : 0ull;

    // removed: invalid, or cleared by a kept box of an earlier block
    const u64 valid_bits = (static_cast<u64>(__ballot_sync(~0u, f1)) << 32) |
                           __ballot_sync(~0u, f0);
    u64 cur = ~valid_bits | or_reduce(col);
    const int left = n - k * kBits;
    const u64 in_range = left >= kBits ? ~0ull : (1ull << left) - 1;
    // the lowest undecided box that is not removed is kept, and clears its
    // later neighbours in this block
    u64 todo = ~cur & in_range;
    while (todo) {
      const int bit = __ffsll(static_cast<long long>(todo)) - 1;
      const u64 d = shfl64(bit < 32 ? d0 : d1, bit & 31);
      cur |= d;
      todo &= todo - 1;
      todo &= ~d;
    }
    const u64 kept = ~cur & in_range;
    const bool kept0 = (kept >> lane) & 1, kept1 = (kept >> (lane + 32)) & 1;
    if (i0 < n) pk[i0] = kept0;
    if (i0 + 32 < n) pk[i0 + 32] = kept1;

    u64 ncol = 0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) ncol |= ahead[u];
    if (more) {
      for (int x = lane + 32 * kAhead; x < n_kept; x += 32)
        ncol |= pm[static_cast<size_t>(kept_list[x]) * words + k + 1];
    }

    // append this block's kept boxes to the list
    const unsigned k0 = static_cast<unsigned>(kept);
    const unsigned k1 = static_cast<unsigned>(kept >> 32);
    const unsigned below = (1u << lane) - 1;
    if (kept0) kept_list[n_kept + __popc(k0 & below)] = i0;
    if (kept1) kept_list[n_kept + __popc(k0) + __popc(k1 & below)] = i0 + 32;
    n_kept += __popcll(kept);
    __syncwarp();

    col = ncol | (kept0 ? own0 : 0ull) | (kept1 ? own1 : 0ull);
    d0 = nd0;
    d1 = nd1;
    f0 = nf0;
    f1 = nf1;
  }
}

}  // namespace

extern "C" int uwcv_nms_greedy(const void* boxes, const void* valid, void* keep,
                               void* mask, int problems, int n,
                               float threshold, void* stream) {
  if (problems <= 0 || n <= 0) return 0;
  if (n > kMaxWords * kBits || problems > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (n + kBits - 1) / kBits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, problems), kBits, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<u64*>(mask), n, words,
      threshold);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<problems, 32, 0, s>>>(
      static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), n, words);
  return static_cast<int>(cudaGetLastError());
}
