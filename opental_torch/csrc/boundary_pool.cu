// Boundary max pooling, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel opental_tpu/ops/boundary_pool_pallas.py:38
// (_fwd_kernel, launched by _pallas_forward / make_boundary_max_pool).
// Contract, as the JAX op (ops/boundary_pool.py): x (B, T, C) row-major,
// segments (B, K, 4) float32, out (B, K, C) in x's dtype, with
//   out[b, k, c] = max over t in [l, r] of x[b, t, c],
// channel half h = c / (C/2) reading (l, r) = segments[b, k, 2h : 2h+2]
// truncated toward zero, clamped to [0, T-1], then r = max(r, l).
//
// What bounds it: bytes. It does one compare per element read, far below
// the card's compute rate, so the least time is the bytes it must move
// (the x rows its windows cover, the segments, out) over 3.35 TB/s.
//
// Design: one thread per output element (b, k, c), threads along c, so
// every step t of a thread's window loop reads one coalesced row of x
// (a warp reads 32 neighbouring channels). Each thread loops only over
// its own window, O(sum of window lengths * C) work, where the TPU kernel
// ran a masked max over all of T for every k (O(K * T * C)) because a
// whole (T, C) block sat in VMEM. The max is taken in float32 and stored
// in x's dtype, which is exact. Rows that neighbouring k's windows share
// are re-read through L1/L2, not device memory; tiling them through
// shared memory, and batching a branch's 6 levels into one launch, are
// left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void boundary_max_pool_fwd_kernel(const T* __restrict__ x,
                                             const float* __restrict__ seg,
                                             T* __restrict__ out, int t_len,
                                             int channels, int k_num) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  if (c >= channels) return;
  const int h = c >= channels / 2 ? 1 : 0;
  const float* s = seg + ((size_t)b * k_num + k) * 4 + 2 * h;
  // __float2int_rz truncates toward zero like static_cast<int>, and
  // saturates instead of overflowing
  int l = __float2int_rz(s[0]);
  int r = __float2int_rz(s[1]);
  l = min(max(l, 0), t_len - 1);
  r = min(max(r, 0), t_len - 1);
  r = max(r, l);
  const T* xp = x + ((size_t)b * t_len + l) * channels + c;
  float m = __int_as_float(0xff800000);  // -inf
  for (int t = l; t <= r; ++t, xp += channels) m = fmaxf(m, load_f(xp));
  store_f(out + ((size_t)b * k_num + k) * channels + c, m);
}

template <typename T>
void launch(const void* x, const void* seg, void* out, int b, int t_len,
            int channels, int k_num, cudaStream_t stream) {
  const int threads = channels >= 256 ? 256 : ((channels + 31) / 32) * 32;
  dim3 grid((channels + threads - 1) / threads, k_num, b);
  boundary_max_pool_fwd_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(seg),
      static_cast<T*>(out), t_len, channels, k_num);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 on success); does not synchronise.
extern "C" int boundary_max_pool_fwd(const void* x, const void* seg,
                                     void* out, int b, int t_len,
                                     int channels, int k_num, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b > 65535 || k_num > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    launch<float>(x, seg, out, b, t_len, channels, k_num, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, seg, out, b, t_len, channels, k_num, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
