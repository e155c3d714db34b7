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
// Design: one block per output tile (b, v, p): the 2 (a_t + fp - 1)
// frames x 2 rows x C channels x Wp of x that the tile needs are copied
// into shared memory, threads along W (coalesced where W is the
// unit-stride axis, as in the model's layout), each thread with 8 loads
// in flight before it stores any (one load at a time left the block
// waiting on memory latency); then each output
// element of the tile is written once, one warp a row of the layout's
// contiguous axis (the 8 a_t C channels of one q for v1, the Wp/2
// columns of one channel and sub-frame for v2), so every store
// coalesces. The tile is a permutation of exactly the input it read (for
// fp = 1), so nothing is read twice within a block; the a_t-fold temporal
// overlap between neighbouring u is re-read by the blocks next in launch
// order and hits L2. A per-channel table of source offsets in shared
// memory and row-wise stores keep integer division out of the output
// loop (a first version that decomposed a flat index per element with
// runtime divisions took the same time in f32 as in bf16: it was bound by
// that arithmetic, not by bytes). Stores are one element a thread;
// vector stores, TMA, and fusing the pack into the convolution's operand
// load are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 8;

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
  constexpr int kWarps = kThreads / 32;
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

template <typename T, bool kV2>
int launch(const void* x, void* z, int b, int tp, int hp, int wp, int c,
           const long long* strides, int a_t, int fp, cudaStream_t stream) {
  const int t_out = tp / 2 - a_t + 1;
  const int t2 = t_out / fp;
  const int ch_n = 8 * a_t * c;
  const size_t rows = (size_t)2 * (a_t + fp - 1) * 2 * c;
  const size_t smem = ch_n * sizeof(int) + rows * sizeof(long long) +
                      rows * wp * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stem_pack_kernel<T, kV2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(hp / 2, t2, b);
  stem_pack_kernel<T, kV2><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(z), wp, c, a_t, fp, t2,
      hp / 2, strides[0], strides[1], strides[2], strides[3], strides[4]);
  return 0;
}

}  // namespace

// x: (B, Tp, Hp, Wp, C) with element strides strides[0..4]; z contiguous,
// v1 (layout 0, fp must be 1) or v2 (layout 1). dtype: 0 = float32,
// 1 = bfloat16. The caller checks the shapes (even Tp, Hp, Wp; t_out a
// multiple of fp). Returns cudaGetLastError() after the launch (0 on
// success); does not synchronise.
extern "C" int stem_pack96(const void* x, void* z, int b, int tp, int hp,
                           int wp, int c, const long long* strides, int a_t,
                           int fp, int layout, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t_out = tp / 2 - a_t + 1;
  if (b < 1 || b > 65535 || t_out < 1 || fp < 1 || t_out % fp ||
      t_out / fp > 65535 || (layout == 0 && fp != 1))
    return (int)cudaErrorInvalidValue;
  int err;
  if (dtype == 0 && layout == 0) {
    err = launch<float, false>(x, z, b, tp, hp, wp, c, strides, a_t, fp, st);
  } else if (dtype == 0 && layout == 1) {
    err = launch<float, true>(x, z, b, tp, hp, wp, c, strides, a_t, fp, st);
  } else if (dtype == 1 && layout == 0) {
    err = launch<__nv_bfloat16, false>(x, z, b, tp, hp, wp, c, strides, a_t,
                                       fp, st);
  } else if (dtype == 1 && layout == 1) {
    err = launch<__nv_bfloat16, true>(x, z, b, tp, hp, wp, c, strides, a_t,
                                      fp, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
