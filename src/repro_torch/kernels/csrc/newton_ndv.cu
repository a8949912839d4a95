// Batched Newton-Raphson NDV solves for Hopper (sm_90a), one thread per lane.
//
// Replaces the TPU kernels in src/repro/kernels/newton_ndv.py:
//   dict_newton   (pallas_call at newton_ndv.py:147, math :50-65)  Eq 2
//   coupon_newton (pallas_call at newton_ndv.py:170, math :68-88)  Eq 8
//
// What bounds it on this card: per lane, dict_newton reads 16 B and writes
// 4 B around ~330 operations (16 iterations of log2, ceil, two IEEE
// divisions and a dozen adds, multiplies and clamps); coupon_newton reads
// 8 B and writes 4 B around ~745 (40 iterations of exp, expm1, exp and two
// divisions). Counted one operation each against 67 TFLOP/s of FP32, and
// the bytes against 3.35 TB/s, dict_newton is about balanced and
// coupon_newton is operation-bound. In practice neither reaches that
// bound: an IEEE division and an accurate log2f / expf / expm1f each
// expand to 10-30 instructions, so the instruction issue rate of the SMs
// is what limits both kernels, not device memory.
//
// Design: one thread per lane with a grid-stride loop; the iteration loops
// are unrolled (their counts are compile-time constants, as on the TPU,
// where every lane ran a fixed count). No shared memory, no cross-lane
// traffic: the only device-memory accesses are one coalesced load per input
// and one coalesced store per lane.
//
// Numerics: the library is compiled WITHOUT fast math and with
// -fmad=false, so every operation rounds as the plain PyTorch version's
// separate elementwise ops do:
//   * log2f / ceilf, not lg2.approx: _ceil_log2 turns log2 into a bit width
//     with ceil, and at exact powers of two an approximate log2 flips the
//     width, after which the plateau snap picks another root;
//   * IEEE division (nvcc's default -prec-div=true);
//   * expf / expm1f / logf from CUDA's accurate libm.
// Clamps and guards are applied in the same order as the reference math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDictIters = 16;
constexpr int kCouponIters = 40;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM at most

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // jnp.clip / torch.clamp order: max with the low bound first, then min.
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float ceil_log2(float x) {
  return fmaxf(ceilf(log2f(fmaxf(x, 1.0f)) - 1e-9f), 1.0f);
}

__device__ float dict_newton_lane(float s, float rows, float nulls, float mean_len) {
  const float non_null = fmaxf(rows - nulls, 0.0f);
  mean_len = fmaxf(mean_len, 1e-6f);
  const float cap = fmaxf(non_null, 1.0f);

  float ndv = clampf(s / mean_len, 1.0f, cap);
#pragma unroll
  for (int it = 0; it < kDictIters; ++it) {
    const float f = ndv * mean_len + non_null * ceil_log2(ndv) / 8.0f - s;
    const float fp = mean_len + non_null / (8.0f * fmaxf(ndv, 1.0f) * kLn2);
    ndv = clampf(ndv - f / fp, 1.0f, cap);
  }
  // Plateau snap: solve the linear piece at the converged bit width.
  const float bits = ceil_log2(ndv);
  const float lin = (s - non_null * bits / 8.0f) / mean_len;
  const bool keep = (ceil_log2(fmaxf(lin, 1.0f)) == bits) && (lin >= 1.0f);
  return clampf(keep ? lin : ndv, 1.0f, cap);
}

__device__ float coupon_newton_lane(float m, float n) {
  const bool saturated = m >= n - 0.5f;
  float m_eff = saturated ? fmaxf(n - 0.5f, 0.5f) : m;
  m_eff = clampf(m_eff, 0.5f, fmaxf(n - 1e-3f, 0.5f));

  float t = logf(clampf(n * n / (2.0f * fmaxf(n - m_eff, 1e-3f)), 1.0f, 1e12f));
#pragma unroll 4
  for (int it = 0; it < kCouponIters; ++it) {
    const float ndv = expf(t);
    const float r = n / fmaxf(ndv, 1e-9f);
    const float em1 = -expm1f(-r);             // 1 - e^{-r}
    const float g = ndv * em1 - m_eff;
    const float gp = em1 - expf(-r) * r;       // g'(D)
    t = clampf(t - g / fmaxf(gp * ndv, 1e-12f), 0.0f, 28.0f);
  }
  float ndv = expf(t);
  // Saturated (m == n): the MLE diverges, report the observable m.
  const float m1 = fmaxf(m, 1.0f);
  ndv = saturated ? m1 : ndv;
  ndv = (n <= 0.0f) ? 1.0f : ndv;
  ndv = (m_eff <= 0.5001f) ? m1 : ndv;
  return fmaxf(ndv, m1);
}

__global__ void __launch_bounds__(kThreads)
dict_newton_kernel(const float* __restrict__ s, const float* __restrict__ rows,
                   const float* __restrict__ nulls, const float* __restrict__ mean_len,
                   float* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    out[i] = dict_newton_lane(s[i], rows[i], nulls[i], mean_len[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
coupon_newton_kernel(const float* __restrict__ m, const float* __restrict__ n_draws,
                     float* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    out[i] = coupon_newton_lane(m[i], n_draws[i]);
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 arrays of length n.
// Launches on `stream` of CUDA device `device`, allocates nothing, and
// returns cudaGetLastError().
int dict_newton_launch(const void* s, const void* rows, const void* nulls,
                       const void* mean_len, void* out, int64_t n, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    dict_newton_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)s, (const float*)rows, (const float*)nulls,
        (const float*)mean_len, (float*)out, n);
  }
  return (int)cudaGetLastError();
}

int coupon_newton_launch(const void* m, const void* n_draws, void* out, int64_t n,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    coupon_newton_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)m, (const float*)n_draws, (float*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
