// The I3D's 3D max pool for Hopper (sm_90a): max over a (KT, KH, KW)
// window at stride (ST, SH, SW) of a TF-SAME zero-padded (N, C, T, H, W)
// tensor, in one launch, the pad computed and no indices written.
//
// Replaces no TPU kernel: the JAX package pools with lax.reduce_window,
// which XLA fuses with its pad (opental_tpu/models/layers.py,
// max_pool_3d_same). Eager PyTorch writes the padded copy (F.pad) and then
// runs max_pool3d_with_indices, which also writes an int64 index per
// output, launches (32, 8)-thread blocks over each output (H, W) plane
// (most threads idle on the I3D's 24^2 to 3^2 planes) and splits N x C x
// T_out into grid-z chunks of 65,535: 723 launches and ~2 % of the byte
// bound over a 128-window forward's 13 pools.
//
// Contract (ops/max_pool3d_cuda.py): x (N C, Ti, Hi, Wi) contiguous
// float32 or bfloat16; y (N C, To, Ho, Wo) contiguous;
// (pt, ph, pw) the front pads of TF-SAME (the back pads follow from the
// output size). y[v, t, h, w] = max over the window of the padded x, with
// out-of-range taps reading +0.0. The max is max.NaN: a NaN anywhere in a
// window gives NaN, as PyTorch's `val > max || isnan(val)` does. A max is
// exact, so every output equals F.max_pool3d(F.pad(x)) in value; only the
// sign of a zero that ties with another zero, and a NaN's payload, may
// differ in their bits.
//
// What bounds it: bytes. It does ~0.5 FLOP a byte (a compare per tap), so
// the least time is (x bytes + y bytes) / 3.35 TB/s: 165 MB, 49 us, for a
// 256-frame 96 x 96 window's 13 bf16 pools.
//
// Design: each block takes Fo consecutive output frames of the flat
// (volume, t_out) axis, chosen so that the input frames they read fill
// about kTileBytes. Frames of one volume are contiguous and volumes
// follow each other, so those input frames are one contiguous range:
// whole small volumes (3^2, 6^2 planes) pack into one block, and long
// large-plane volumes (48^2, 24^2, 12^2) split into slabs of T whose
// one-frame halo (kT = 3) is the only input read twice, from L2. The
// block copies its range into shared memory with 16-byte cp.async (the
// unaligned head and tail element by element). A thread then owns one
// output position (ho, wo) over a run of the block's output frames: its
// KH x KW tap offsets, and which of them lie in the pad, are fixed, so a
// frame's spatial max is KH KW shared-memory loads with no bounds test
// (a pad tap reads an in-frame tap again and the pad's zero joins once),
// and the KT-frame max slides along the run in registers (kT = 3 at
// stride 1: one spatial max a frame, not three). The block's positions
// times its runs are about kThreads items, so every thread has work at
// every plane size. The output tile, in shared memory laid out as y's
// bytes, leaves with 16-byte stores. Templated on the four (kernel,
// stride) specs of the I3D and on the element type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // items a block, about
constexpr int kMaxThreads = 1024;
constexpr int kTileBytes = 32 * 1024;  // input frames a block loads
constexpr int kMaxSmem = 227 * 1024;

// n / d for 0 <= n < 2^31 by a multiply and a shift (PyTorch's
// IntDivider): the divisors are the tile's extents, known at launch.
struct FastDiv {
  unsigned m, s;
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while ((1u << s) < d) ++s;
  const uint64_t one = 1;
  return {(unsigned)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return (int)((__umulhi((unsigned)n, f.m) + (unsigned)n) >> f.s);
}

struct Params {
  int ti, hi, wi, to, ho, wo;      // extents of a volume, in and out
  int pt, ph, pw;                  // TF-SAME front pads
  int frames;                      // output frames a block (Fo)
  int out_frames;                  // N C To
  int out_off;                     // bytes: the output tile's offset
  int runs;                        // runs of frames an output position
  FastDiv to_div, hwo_div, wo_div;
};

__device__ __forceinline__ float vmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ __nv_bfloat16 vmax(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return __hmax_nan(a, b);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Copy `bytes` bytes starting `head` bytes into the 16-byte aligned
// window at `src` (global) to the same offsets of `dst` (shared): whole
// 16-byte chunks with cp.async, the partial first and last chunk one
// element of E bytes at a time. A thread starts all its chunks before
// the one wait; plain 16-byte loads through registers took 15 % longer
// over a W = 128 bf16 forward's 13 calls on an H100 (13.20 against
// 11.48 ms).
template <int E>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const unsigned char* src,
                                          int head, int bytes) {
  const int chunks = (bytes + 15) >> 4;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int b0 = c << 4;
    if (b0 >= head && b0 + 16 <= bytes) {
      cp_async16(dst + b0, src + b0);
    } else {
      for (int b = max(b0, head); b < min(b0 + 16, bytes); b += E) {
        if (E == 4)
          *reinterpret_cast<uint32_t*>(dst + b) =
              *reinterpret_cast<const uint32_t*>(src + b);
        else
          *reinterpret_cast<uint16_t*>(dst + b) =
              *reinterpret_cast<const uint16_t*>(src + b);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int KT, int KH, int KW, int ST, int SH, int SW>
__global__ void __launch_bounds__(kMaxThreads)
    max_pool3d_same_kernel(const T* __restrict__ x, T* __restrict__ y,
                           Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = sizeof(T);
  const int hw_in = p.hi * p.wi, hw_out = p.ho * p.wo;

  // the block's output frames [g0, g1) and the input frames they read
  const int g0 = blockIdx.x * p.frames;
  const int g1 = min(g0 + p.frames, p.out_frames);
  const int v0 = fdiv(g0, p.to_div), t0 = g0 - v0 * p.to;
  const int vl = fdiv(g1 - 1, p.to_div), tl = g1 - 1 - vl * p.to;
  const long long f_lo = (long long)v0 * p.ti + max(t0 * ST - p.pt, 0);
  const long long f_hi =
      (long long)vl * p.ti + min(tl * ST - p.pt + KT, p.ti);
  const int n_in = (int)(f_hi - f_lo);

  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(x + f_lo * hw_in);
  const int head = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  load_tile<E>(smem, src - head, head, head + n_in * hw_in * E);
  __syncthreads();

  // the output tile, laid out as y's bytes from a 16-byte boundary
  const T* xs = reinterpret_cast<const T*>(smem + head);
  unsigned char* dst =
      reinterpret_cast<unsigned char*>(y + (long long)g0 * hw_out);
  const int head_y = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  T* ys = reinterpret_cast<T*>(smem + p.out_off + head_y);
  const int n_fr = g1 - g0;
  const int run = (n_fr + p.runs - 1) / p.runs;

  // an item is one output position q = (ho, wo) over a run of the
  // block's output frames; its taps' offsets in a frame and whether
  // each lies inside it are the same for every frame
  for (int i = threadIdx.x; i < p.runs * hw_out; i += blockDim.x) {
    const int c = fdiv(i, p.hwo_div);
    const int q = i - c * hw_out;
    const int lf0 = c * run, lf1 = min(lf0 + run, n_fr);
    if (lf0 >= lf1) continue;
    const int ho = fdiv(q, p.wo_div), wo = q - ho * p.wo;
    // a tap in the pad reads a tap inside the frame instead (a max is
    // idempotent), and the pad's zero joins the max once
    constexpr int K = KH * KW;
    int off[K];
    int inside = 0, first = 0;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const int h = ho * SH - p.ph + k / KW, w = wo * SW - p.pw + k % KW;
      const bool in =
          (unsigned)h < (unsigned)p.hi && (unsigned)w < (unsigned)p.wi;
      off[k] = h * p.wi + w;
      if (in) first = off[k];
      inside += in;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int h = ho * SH - p.ph + k / KW, w = wo * SW - p.pw + k % KW;
      if (!((unsigned)h < (unsigned)p.hi && (unsigned)w < (unsigned)p.wi))
        off[k] = first;
    }
    auto spatial = [&](int frame) -> T {
      if (!inside) return zero<T>();
      const T* f = xs + frame * hw_in;
      T m = f[off[0]];
#pragma unroll
      for (int k = 1; k < K; ++k) m = vmax(m, f[off[k]]);
      return inside < K ? vmax(m, zero<T>()) : m;
    };
    // the KT frames' spatial maxima of the previous output frame slide
    // into this one's where both are of one volume (stride ST < KT)
    T win[KT];
    const int g = g0 + lf0;
    int v = fdiv(g, p.to_div), t = g - v * p.to;
    int base = (int)((long long)v * p.ti - f_lo);
    for (int lf = lf0; lf < lf1; ++lf) {
      const bool slide = lf > lf0 && t > 0;
      const int t_in = t * ST - p.pt;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (k + ST < KT && slide) {
          win[k] = win[k + ST];
        } else {
          win[k] = (unsigned)(t_in + k) < (unsigned)p.ti
                       ? spatial(base + t_in + k)
                       : zero<T>();
        }
      }
      T m = win[0];
#pragma unroll
      for (int k = 1; k < KT; ++k) m = vmax(m, win[k]);
      ys[lf * hw_out + q] = m;
      if (++t == p.to) {
        t = 0;
        base += p.ti;
      }
    }
  }
  __syncthreads();

  const int bytes = head_y + n_fr * hw_out * E;
  const int chunks = (bytes + 15) >> 4;
  const unsigned char* out = smem + p.out_off;
  unsigned char* base_y = dst - head_y;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int b0 = c << 4;
    if (b0 >= head_y && b0 + 16 <= bytes) {
      *reinterpret_cast<uint4*>(base_y + b0) =
          *reinterpret_cast<const uint4*>(out + b0);
    } else {
      for (int b = max(b0, head_y); b < min(b0 + 16, bytes); b += E)
        *reinterpret_cast<T*>(base_y + b) =
            *reinterpret_cast<const T*>(out + b);
    }
  }
}

template <typename T, int KT, int KH, int KW, int ST, int SH, int SW>
int launch(const void* x, void* y, int planes, int ti, int hi, int wi,
           int to, int ho, int wo, int pt, int ph, int pw,
           cudaStream_t stream) {
  constexpr int E = sizeof(T);
  const long long hw_in = (long long)hi * wi, hw_out = (long long)ho * wo;
  // output frames a block: their input frames, (Fo - 1) ST + KT at most,
  // fill about kTileBytes
  long long fo = (kTileBytes / (hw_in * E) - KT) / ST + 1;
  if (fo < 1) fo = 1;
  const long long out_frames = (long long)planes * to;
  if (fo > out_frames) fo = out_frames;
  const long long max_in = (fo - 1) * ST + KT;
  const long long out_off = (16 + max_in * hw_in * E + 15) / 16 * 16;
  const long long smem_bytes = out_off + 16 + fo * hw_out * E;
  if (smem_bytes > kMaxSmem || (long long)planes * ti >= (1LL << 31) ||
      out_frames + fo >= (1LL << 31) || max_in * hw_in >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // about kThreads items a block: each output position's frames split
  // into `runs` runs (a run slides its window over frames in registers)
  long long runs = (kThreads + hw_out / 2) / hw_out;
  if (runs < 1) runs = 1;
  if (runs > fo) runs = fo;
  long long threads = (runs * hw_out + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  Params p;
  p.ti = ti;
  p.hi = hi;
  p.wi = wi;
  p.to = to;
  p.ho = ho;
  p.wo = wo;
  p.pt = pt;
  p.ph = ph;
  p.pw = pw;
  p.frames = (int)fo;
  p.out_frames = (int)out_frames;
  p.out_off = (int)out_off;
  p.runs = (int)runs;
  p.to_div = make_div(to);
  p.hwo_div = make_div((unsigned)hw_out);
  p.wo_div = make_div(wo);
  auto kernel = max_pool3d_same_kernel<T, KT, KH, KW, ST, SH, SW>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (out_frames + fo - 1) / fo;
  kernel<<<(unsigned)blocks, (unsigned)threads, (size_t)smem_bytes,
           stream>>>(static_cast<const T*>(x), static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, void* y, int planes, int ti, int hi, int wi,
             int to, int ho, int wo, int kt, int kh, int kw, int st, int sh,
             int sw, int pt, int ph, int pw, cudaStream_t stream) {
#define MAX_POOL3D_SPEC(KT, KH, KW, ST, SH, SW)                              \
  if (kt == KT && kh == KH && kw == KW && st == ST && sh == SH && sw == SW) \
    return launch<T, KT, KH, KW, ST, SH, SW>(x, y, planes, ti, hi, wi, to,  \
                                             ho, wo, pt, ph, pw, stream);
  MAX_POOL3D_SPEC(1, 3, 3, 1, 2, 2)
  MAX_POOL3D_SPEC(3, 3, 3, 1, 1, 1)
  MAX_POOL3D_SPEC(3, 3, 3, 2, 2, 2)
  MAX_POOL3D_SPEC(2, 2, 2, 2, 2, 2)
#undef MAX_POOL3D_SPEC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype 0: float32, 1: bfloat16. Returns the CUDA error of the launch
// (cudaErrorInvalidValue for a spec or an extent it does not take).
extern "C" int max_pool3d_same(const void* x, void* y, int planes, int ti,
                               int hi, int wi, int to, int ho, int wo,
                               int kt, int kh, int kw, int st, int sh,
                               int sw, int pt, int ph, int pw, int dtype,
                               void* stream) {
  if (planes <= 0 || ti <= 0 || hi <= 0 || wi <= 0 || to <= 0 || ho <= 0 ||
      wo <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, y, planes, ti, hi, wi, to, ho, wo, kt, kh, kw,
                           st, sh, sw, pt, ph, pw, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, y, planes, ti, hi, wi, to, ho, wo, kt,
                                   kh, kw, st, sh, sw, pt, ph, pw, s);
  return (int)cudaErrorInvalidValue;
}
