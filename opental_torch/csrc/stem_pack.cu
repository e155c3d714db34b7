// Space-to-depth + temporal-tap packing of the I3D stem, for Hopper
// (sm_90a), in both of the JAX package's layouts.
//
// Replaces the TPU kernels opental_tpu/ops/stem_pack_pallas.py:44
// (_kernel, launched by stem_pack96: v1, channels-last) and :141
// (_kernel_v2, launched by stem_pack96_v2 and consumed by stem_conv_v2:
// v2, channel-leading with fp frames side by side). Contract, as the JAX
// op: x is the padded video (B, Tp, Hp, Wp, C), read through five element
// strides (so a permuted view of the model's (B, C, Tp, Hp, Wp) tensor is
// read as it is), and
//   z[b, u, p, q, ch] = x[b, 2u + r, 2p + bi, 2q + bj, c],
//   ch = ((r * 2 + bi) * 2 + bj) * C + c,  r in [0, 2 a_t),
// for u < t_out = Tp/2 - a_t + 1. v1 stores z contiguous as (B, t_out,
// Hp/2, Wp/2, 8 a_t C); v2 as (B, t_out/fp, 8 a_t C, Hp/2, fp Wp/2) with
// z2[b, v, ch, p, s Wp/2 + q] = z[b, fp v + s, p, q, ch]. The TPU
// kernel's input went through host_prelayout, which pads H to a multiple
// of 8 and the lanes to 128 for Mosaic's DMA tiling; that is no part of
// the function and this kernel has none of it.
//
// What bounds it: bytes. It only moves values, so the least time is the
// distinct bytes of x it needs (every element once) plus z, over
// 3.35 TB/s. z holds 2 a_t t_out / Tp times the padded input's elements
// (3.9 x for a 256-frame clip at a_t = 4), so the stores dominate.
//
// Two designs, picked by the caller (ops/stem_pack_cuda.py `plan`):
//
// * Frame-major (v2 at fp = 1, the model's inference path: B4). At
//   fp = 1, input plane (b, f, c) feeds the destinations u with
//   r = f - 2u in [0, 2 a_t), at most a_t of them, and for each one its
//   four sub-planes (bi, bj) are whole channels of z2: runs of
//   Hp/2 * Wp/2 contiguous elements. So one block takes a band of rows
//   of one plane: it reads the band once (each input element is read
//   from device memory once in the whole launch), splits it into the
//   four (bi, bj) sub-planes in shared memory, and writes each sub-plane
//   to every destination as one contiguous run. Loads: where the band is
//   contiguous (unit W stride and packed rows, as in the model's view),
//   one thread issues a single bulk copy (cp.async.bulk, completion on an
//   mbarrier) of the 16-byte-aligned span that covers it and the split
//   indexes past the lead; other strides take strided loads straight into
//   the split. Stores: one warp per (destination, sub-plane) run, 16-byte
//   vector stores along it with a scalar head and tail. The runs of one
//   sub-plane start at the same address mod 16 for every destination
//   (they are 8 C (a_t - 1) Hp/2 Wp/2 elements apart), so each sub-plane
//   is placed in shared memory at that alignment and the stores read it
//   as aligned 16-byte vectors too. No integer division runs per
//   element. Bands are capped at kBandBytes so that five blocks share an
//   SM: their loads, splits and stores overlap one another, which takes
//   the place of a ring of stages inside one block.
// * Tile (v1, B3; and v2 at fp > 1): one block per output tile (b, v, p):
//   the 2 (a_t + fp - 1) frames x 2 rows x C channels x Wp of x that the
//   tile needs are copied into shared memory, threads along W, each
//   thread with 8 loads in flight; then each output element of the tile
//   is written once, one warp a row of the layout's contiguous axis (the
//   8 a_t C channels of one q for v1, the Wp/2 columns of one channel and
//   sub-frame for v2), from a per-channel table of source offsets. The
//   a_t-fold temporal overlap between neighbouring u is re-read by the
//   blocks next in launch order and hits L2. For v1 a frame supplies
//   only 12 of every 96 channels of a row, so the frame-major plan would
//   store pieces of 4 C elements, 8 a_t C apart: the tile plan stays.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;
constexpr int kBandBytes = 24 * 1024;  // raw band cap of the frame plan

template <typename T, bool kV2>
__global__ void __launch_bounds__(kThreads)
    stem_pack_kernel(const T* __restrict__ x, T* __restrict__ z, int wp,
                     int c, int a_t, int fp, int t2, int h2, long long sb,
                     long long st, long long sh, long long sw,
                     long long sc) {
  extern __shared__ int smem[];
  const int ch_n = 8 * a_t * c;
  const int rows = 2 * (a_t + fp - 1) * 2 * c;  // (f, bi, c) rows of the tile
  int* src = smem;  // (ch_n): offset of channel ch's row in the tile
  long long* roff = reinterpret_cast<long long*>(smem + ch_n);  // (rows)
  T* tile = reinterpret_cast<T*>(roff + rows);
  const int p = blockIdx.x;
  const int v = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wq = wp / 2;
  const int row = 2 * c * wp;  // one frame of the tile: (bi, c, w)

  for (int ch = threadIdx.x; ch < ch_n; ch += kThreads) {
    const int cc = ch % c;
    const int bj = (ch / c) % 2;
    const int bi = (ch / (2 * c)) % 2;
    const int r = ch / (4 * c);
    src[ch] = r * row + (bi * c + cc) * wp + bj;
  }
  for (int k = threadIdx.x; k < rows; k += kThreads) {
    const int cc = k % c;
    const int bi = (k / c) % 2;
    const int f = k / (2 * c);
    roff[k] = f * st + bi * sh + cc * sc;
  }
  __syncthreads();
  // tile[f][bi][c][w] = x[b, 2 fp v + f, 2p + bi, w, c], threads along w;
  // each thread has kLoads loads in flight before it stores any
  const T* xb = x + b * sb + (2LL * fp * v) * st + (2LL * p) * sh;
  const int n_in = rows * wp;
  for (int i0 = threadIdx.x; i0 < n_in; i0 += kLoads * kThreads) {
    T val[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n_in) {
        const int k = i / wp;
        val[j] = xb[roff[k] + (i - k * wp) * sw];
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n_in) tile[i] = val[j];
    }
  }
  __syncthreads();

  if (!kV2) {
    // v1 tile: z[b, v, p, q, :] for every q, contiguous; one warp a q,
    // lanes along the channels
    T* zt = z + (((long long)b * t2 + v) * h2 + p) * (long long)wq * ch_n;
    for (int q = warp; q < wq; q += kWarps) {
      for (int ch = lane; ch < ch_n; ch += 32)
        zt[q * ch_n + ch] = tile[src[ch] + 2 * q];
    }
  } else {
    // v2 tile: rows z[b, v, ch, p, :] of fp * wq elements, h2 rows
    // apart; one warp a channel, lanes along q within each sub-frame s
    const int lanes = fp * wq;
    T* zt = z + ((long long)b * t2 + v) * ch_n * (long long)h2 * lanes +
            (long long)p * lanes;
    for (int ch = warp; ch < ch_n; ch += kWarps) {
      T* zr = zt + (long long)ch * h2 * lanes;
      for (int s = 0; s < fp; ++s) {
        const T* tr = tile + src[ch] + 2 * s * row;
        for (int q = lane; q < wq; q += 32) zr[s * wq + q] = tr[2 * q];
      }
    }
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Frame plan (v2, fp = 1). Block (c * nb + band, f, b) packs rows
// [2 p0, 2 p0 + 2 n) of plane x[b, f, :, :, c], p0 = band * n_band.
// Shared memory: the four sub-planes split[s], s = bi * 2 + bj, each of
// n * wq elements, at stride ls and shifted to their destinations'
// alignment; then (kBulk) the raw band as copied.
template <typename T, bool kBulk>
__global__ void __launch_bounds__(kThreads)
    stem_pack_frames_kernel(const T* __restrict__ x, T* __restrict__ z,
                            int wp, int c, int a_t, int t_out, int h2,
                            int n_band, int nb, int raw_off, long long sb,
                            long long st, long long sh, long long sw,
                            long long sc) {
  extern __shared__ __align__(128) unsigned char fsmem[];
  __shared__ __align__(8) unsigned long long bar;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int cc = blockIdx.x / nb;
  const int p0 = (blockIdx.x - cc * nb) * n_band;
  const int f = blockIdx.y;
  const int b = blockIdx.z;
  const int wq = wp / 2;
  const int n = min(n_band, h2 - p0);
  const int len = n * wq;  // elements of one run
  const int ls = (n_band * wq + kVec - 1) / kVec * kVec + kVec;
  // destinations u of frame f: r = f - 2u in [0, 2 a_t), u < t_out
  const int u_lo = max(0, (f - 2 * a_t + 2) / 2);
  const int nd = min(t_out - 1, f / 2) - u_lo + 1;
  const int ch_n = 8 * a_t * c;
  const long long plane = (long long)h2 * wq;
  // run (u, s) starts at z + zrun(u) + s * c * plane
  auto zrun = [&](int u) {
    return (((long long)b * t_out + u) * ch_n + (f - 2 * u) * 4 * c + cc) *
               plane + (long long)p0 * wq;
  };
  const uintptr_t z_lo = reinterpret_cast<uintptr_t>(z + zrun(u_lo));
  auto sub = [&](int s) {  // offset of split[s]: ls apart, dest-aligned
    const uintptr_t a = z_lo + (uintptr_t)s * c * plane * sizeof(T);
    return s * ls + (int)((a & 15) / sizeof(T));
  };
  T* split = reinterpret_cast<T*>(fsmem);
  const T* src = x + b * sb + f * st + cc * sc + 2LL * p0 * sh;
  int lead = 0;
  if (kBulk) {
    // one bulk copy of the 16-byte-aligned span over the band's 2 n wp
    // contiguous elements (it stays inside the allocation: 16-byte
    // segments of device memory are mapped whole)
    const T* raw = reinterpret_cast<const T*>(fsmem + raw_off);
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a0 = a & ~uintptr_t(15);
    lead = (int)((a - a0) / sizeof(T));
    const unsigned bytes =
        (unsigned)(((a - a0) + 2ull * n * wp * sizeof(T) + 15) & ~15ull);
    const unsigned mbar = smem_u32(&bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(mbar), "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(raw)),
          "l"(a0), "r"(bytes), "r"(mbar)
          : "memory");
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(mbar), "r"(0u)
          : "memory");
    }
  }
  // split: row 2 (p - p0) + bi of the band, column 2 q + bj -> split[s]
  // at (p - p0) wq + q; one warp a row, lanes along w
  const T* raw = reinterpret_cast<const T*>(fsmem + raw_off) + lead;
  for (int row = warp; row < 2 * n; row += kWarps) {
    const int bi = row & 1;
    T* d0 = split + sub(2 * bi) + (row >> 1) * wq;
    T* d1 = split + sub(2 * bi + 1) + (row >> 1) * wq;
    for (int w = lane; w < wp; w += 32) {
      const T v = kBulk ? raw[row * wp + w] : src[row * sh + w * sw];
      ((w & 1) ? d1 : d0)[w >> 1] = v;
    }
  }
  __syncthreads();
  // stores: one warp a (destination, sub-plane) run of len elements
  for (int run = warp; run < 4 * nd; run += kWarps) {
    const int s = run & 3;
    T* g = z + zrun(u_lo + (run >> 2)) + (long long)s * c * plane;
    const T* sp = split + sub(s);
    const int head = min(
        len,
        (int)(((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) /
              sizeof(T)));
    if (lane < head) g[lane] = sp[lane];
    const int nv = (len - head) / kVec;
    const uint4* sv = reinterpret_cast<const uint4*>(sp + head);
    uint4* gv = reinterpret_cast<uint4*>(g + head);
    for (int i = lane; i < nv; i += 32) gv[i] = sv[i];
    const int tail = head + nv * kVec;
    if (lane < len - tail) g[tail + lane] = sp[tail + lane];
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool kV2>
int launch(const void* x, void* z, int b, int tp, int hp, int wp, int c,
           const long long* strides, int a_t, int fp, cudaStream_t stream) {
  const int t_out = tp / 2 - a_t + 1;
  const int t2 = t_out / fp;
  const int ch_n = 8 * a_t * c;
  const size_t rows = (size_t)2 * (a_t + fp - 1) * 2 * c;
  const size_t smem = ch_n * sizeof(int) + rows * sizeof(long long) +
                      rows * wp * sizeof(T);
  const int e = set_smem((const void*)stem_pack_kernel<T, kV2>, smem);
  if (e != 0) return e;
  dim3 grid(hp / 2, t2, b);
  stem_pack_kernel<T, kV2><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(z), wp, c, a_t, fp, t2,
      hp / 2, strides[0], strides[1], strides[2], strides[3], strides[4]);
  return 0;
}

template <typename T, bool kBulk>
int launch_frames(const void* x, void* z, int b, int tp, int hp, int wp,
                  int c, const long long* s, int a_t, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (kBulk && (s[3] != 1 || s[2] != wp)) return (int)cudaErrorInvalidValue;
  const int h2 = hp / 2;
  const int wq = wp / 2;
  // equal bands of at most kBandBytes of raw rows (at least one row pair)
  const int n_max = max(1, (int)(kBandBytes / (2 * (size_t)wp * sizeof(T))));
  const int n_band = (h2 + (h2 + n_max - 1) / n_max - 1) /
                     ((h2 + n_max - 1) / n_max);
  const int nb = (h2 + n_band - 1) / n_band;
  const size_t ls = ((size_t)n_band * wq + kVec - 1) / kVec * kVec + kVec;
  const size_t raw_off = (4 * ls * sizeof(T) + 127) / 128 * 128;
  const size_t smem =
      raw_off + (kBulk ? (2 * (size_t)n_band * wp * sizeof(T) + 15) / 16 *
                             16 + 16
                       : 0);
  const int e = set_smem((const void*)stem_pack_frames_kernel<T, kBulk>,
                         smem);
  if (e != 0) return e;
  dim3 grid(nb * c, tp, b);
  stem_pack_frames_kernel<T, kBulk><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(z), wp, c, a_t,
      tp / 2 - a_t + 1, h2, n_band, nb, (int)raw_off, s[0], s[1], s[2],
      s[3], s[4]);
  return 0;
}

template <typename T>
int dispatch(const void* x, void* z, int b, int tp, int hp, int wp, int c,
             const long long* strides, int a_t, int fp, int layout, int path,
             cudaStream_t st) {
  if (path == 0 && layout == 0)
    return launch<T, false>(x, z, b, tp, hp, wp, c, strides, a_t, fp, st);
  if (path == 0)
    return launch<T, true>(x, z, b, tp, hp, wp, c, strides, a_t, fp, st);
  if (layout != 1 || fp != 1) return (int)cudaErrorInvalidValue;
  if (path == 1)
    return launch_frames<T, false>(x, z, b, tp, hp, wp, c, strides, a_t, st);
  if (path == 2)
    return launch_frames<T, true>(x, z, b, tp, hp, wp, c, strides, a_t, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (B, Tp, Hp, Wp, C) with element strides strides[0..4]; z contiguous,
// v1 (layout 0, fp must be 1) or v2 (layout 1). dtype: 0 = float32,
// 1 = bfloat16. path: 0 = tile plan; 1 = frame plan with strided loads,
// 2 = frame plan with bulk copies (both v2 at fp = 1 only; 2 needs
// strides[3] == 1 and strides[2] == Wp). The caller checks the shapes
// (even Tp, Hp, Wp; t_out a multiple of fp). Returns cudaGetLastError()
// after the launch (0 on success); does not synchronise.
extern "C" int stem_pack96(const void* x, void* z, int b, int tp, int hp,
                           int wp, int c, const long long* strides, int a_t,
                           int fp, int layout, int dtype, int path,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t_out = tp / 2 - a_t + 1;
  if (b < 1 || b > 65535 || t_out < 1 || fp < 1 || t_out % fp ||
      t_out / fp > 65535 || tp > 65535 || (layout == 0 && fp != 1))
    return (int)cudaErrorInvalidValue;
  int err;
  if (dtype == 0) {
    err = dispatch<float>(x, z, b, tp, hp, wp, c, strides, a_t, fp, layout,
                          path, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(x, z, b, tp, hp, wp, c, strides, a_t, fp,
                                  layout, path, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
