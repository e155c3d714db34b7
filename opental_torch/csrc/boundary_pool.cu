// Boundary max pooling, forward and first-argmax backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels opental_tpu/ops/boundary_pool_pallas.py:38
// (_fwd_kernel, launched by _pallas_forward / make_boundary_max_pool) and
// :57 (_bwd_kernel, launched by _pallas_backward).
// Contract, as the JAX op (ops/boundary_pool.py): x (B, T, C) row-major,
// segments (B, K, 4) float32, out (B, K, C) in x's dtype, with
//   out[b, k, c] = max over t in [l, r] of x[b, t, c],
// channel half h = c / (C/2) reading (l, r) = segments[b, k, 2h : 2h+2]
// truncated toward zero, clamped to [0, T-1], then r = max(r, l).
// Backward: dx[b, t, c] = sum of g[b, k, c] over the k whose FIRST argmax
// in the window is t (ties go to the lowest t); every other entry is 0.
//
// What bounds them: bytes. Each does one compare or one add per element
// it reads, far below the card's compute rate, so the least time is the
// bytes each must move over 3.35 TB/s: for the forward the x rows its
// windows cover, the segments and out (plus the int32 argmax when it is
// asked for); for the backward g, the argmax and dx.
//
// Forward design: one thread per output element (b, k, c), threads along
// c, so every step t of a thread's window loop reads one coalesced row of
// x (a warp reads 32 neighbouring channels). Each thread loops only over
// its own window, O(sum of window lengths * C) work, where the TPU kernel
// ran a masked max over all of T for every k (O(K * T * C)) because a
// whole (T, C) block sat in VMEM. The max is taken in float32 and stored
// in x's dtype, which is exact. A template flag makes the training
// forward also write the int32 first argmax (B, K, C) for the backward;
// the inference forward is the argmax-free instantiation and moves no
// extra bytes. Rows that neighbouring k's windows share are re-read
// through L1/L2, not device memory; tiling them through shared memory,
// and batching a branch's 6 levels into one launch, are left for later.
//
// Backward design: the saved argmax, not x, is read: recomputing it from
// x as _bwd_kernel does would read every window of x again, more bytes
// than the (B, K, C) int32 argmax. One thread per column (b, c), threads
// along c, 32 to a block: each thread zeroes its column of a float32
// accumulator in shared memory (T x 32 words per block, conflict-free
// since thread i always hits bank i), walks k in ascending order and adds
// g[b, k, c] at row argmax[b, k, c], then writes its column of dx once,
// rounded to g's dtype. That is the Pallas kernel's summation order, no
// atomics and a deterministic result; accumulating in float32 makes the
// bfloat16 result exact wherever the float32 sum is. At B = 1 a call
// runs only C threads (512 or 1024): the card is poorly occupied and the
// call is launch-bound. Splitting the k walk over more blocks would need
// a second pass or atomics; left for later, with its times in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBwdThreads = 32;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, bool kArgmax>
__global__ void boundary_max_pool_fwd_kernel(const T* __restrict__ x,
                                             const float* __restrict__ seg,
                                             T* __restrict__ out,
                                             int* __restrict__ argmax,
                                             int t_len, int channels,
                                             int k_num) {
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
  const size_t o = ((size_t)b * k_num + k) * channels + c;
  if (kArgmax) {
    int a = l;
    for (int t = l; t <= r; ++t, xp += channels) {
      const float v = load_f(xp);
      if (v > m) {  // strict: the first t attaining the max wins
        m = v;
        a = t;
      }
    }
    argmax[o] = a;
  } else {
    for (int t = l; t <= r; ++t, xp += channels) m = fmaxf(m, load_f(xp));
  }
  store_f(out + o, m);
}

template <typename T>
__global__ void boundary_max_pool_bwd_kernel(const int* __restrict__ argmax,
                                             const T* __restrict__ g,
                                             T* __restrict__ dx, int t_len,
                                             int channels, int k_num) {
  extern __shared__ float acc[];  // (t_len, kBwdThreads)
  const int tid = threadIdx.x;
  const int c = blockIdx.x * kBwdThreads + tid;
  const int b = blockIdx.y;
  for (int t = 0; t < t_len; ++t) acc[t * kBwdThreads + tid] = 0.0f;
  if (c < channels) {
    const size_t base = (size_t)b * k_num * channels + c;
    for (int k = 0; k < k_num; ++k) {
      const size_t o = base + (size_t)k * channels;
      acc[__ldg(argmax + o) * kBwdThreads + tid] += load_f(g + o);
    }
    T* dp = dx + (size_t)b * t_len * channels + c;
    for (int t = 0; t < t_len; ++t, dp += channels)
      store_f(dp, acc[t * kBwdThreads + tid]);
  }
}

template <typename T>
void launch_fwd(const void* x, const void* seg, void* out, int* argmax,
                int b, int t_len, int channels, int k_num,
                cudaStream_t stream) {
  const int threads = channels >= 256 ? 256 : ((channels + 31) / 32) * 32;
  dim3 grid((channels + threads - 1) / threads, k_num, b);
  if (argmax != nullptr) {
    boundary_max_pool_fwd_kernel<T, true><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(seg),
        static_cast<T*>(out), argmax, t_len, channels, k_num);
  } else {
    boundary_max_pool_fwd_kernel<T, false><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(seg),
        static_cast<T*>(out), nullptr, t_len, channels, k_num);
  }
}

template <typename T>
int launch_bwd(const int* argmax, const void* g, void* dx, int b,
               int t_len, int channels, int k_num, cudaStream_t stream) {
  const size_t smem = (size_t)t_len * kBwdThreads * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        boundary_max_pool_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((channels + kBwdThreads - 1) / kBwdThreads, b);
  boundary_max_pool_bwd_kernel<T><<<grid, kBwdThreads, smem, stream>>>(
      argmax, static_cast<const T*>(g), static_cast<T*>(dx), t_len,
      channels, k_num);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. argmax: null for the inference
// forward, else an int32 (B, K, C) output. Returns cudaGetLastError()
// after the launch (0 on success); does not synchronise.
extern "C" int boundary_max_pool_fwd(const void* x, const void* seg,
                                     void* out, void* argmax, int b,
                                     int t_len, int channels, int k_num,
                                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* am = static_cast<int*>(argmax);
  if (b > 65535 || k_num > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    launch_fwd<float>(x, seg, out, am, b, t_len, channels, k_num, st);
  } else if (dtype == 1) {
    launch_fwd<__nv_bfloat16>(x, seg, out, am, b, t_len, channels, k_num,
                              st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dx (B, T, C) in g's dtype from argmax (B, K, C) int32 in [0, T) and
// g (B, K, C). dtype as above. Returns cudaGetLastError() after the
// launch (0 on success); does not synchronise.
extern "C" int boundary_max_pool_bwd(const void* argmax, const void* g,
                                     void* dx, int b, int t_len,
                                     int channels, int k_num, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* am = static_cast<const int*>(argmax);
  if (b > 65535) return (int)cudaErrorInvalidValue;
  int err = 0;
  if (dtype == 0) {
    err = launch_bwd<float>(am, g, dx, b, t_len, channels, k_num, st);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(am, g, dx, b, t_len, channels, k_num,
                                    st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
