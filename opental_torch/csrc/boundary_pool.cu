// Boundary max pooling, forward and first-argmax backward, for Hopper
// (sm_90a), grouped: one launch runs a whole table of pooling problems
// ("levels") packed along one axis.
//
// Replaces the TPU kernels opental_tpu/ops/boundary_pool_pallas.py:38
// (_fwd_kernel, launched by _pallas_forward / make_boundary_max_pool) and
// :57 (_bwd_kernel, launched by _pallas_backward).
// Contract (ops/boundary_pool.py): x (B, T, C) row-major whose T rows are
// levels i = 0 .. n-1 of t_i rows each, packed in order (T = sum t_i);
// segments (B, K, 4) float32 whose K windows are the levels' k_i windows,
// packed the same way; out (B, K, C) in x's dtype. For window k of level
// i (x_off_i = t_0 + .. + t_{i-1}):
//   out[b, k, c] = max over t in [l, r] of x[b, x_off_i + t, c],
// channel half h = c / (C/2) reading (l, r) = segments[b, k, 2h : 2h+2]
// truncated toward zero, clamped to the level's own rows [0, t_i - 1],
// then r = max(r, l): a window never reads a neighbouring level. The
// argmax is x_off_i + the FIRST t attaining the max (an index into the
// packed T axis). One level (t_0 = T, k_0 = K) is the JAX op itself.
// Backward: dx[b, t, c] = sum of g[b, k, c] over the k whose argmax is t,
// added in ascending k; every other entry is 0.
//
// What bounds them: bytes, at the main path's sizes, and the latency of
// the few dependent round trips each block makes. Each does one compare
// or one add per element it reads, far below the card's compute rate, so
// the least time is the bytes each must move over 3.35 TB/s: for the
// forward every x row that some window covers, read once, the segments
// and out (plus the int32 argmax when it is asked for); for the backward
// g, the argmax and dx. At B = 1 the problems are small (0.5 to 1 MB)
// and a launch's fixed cost weighs as much as the bytes: that is why the
// model runs each pass's pools as one launch (models/pyramid.py).
//
// Forward design: one block per (batch row, channel tile of 128 in one
// half, level, tile of up to 16 of the level's windows), 4 warps. The
// block reads its windows' (l, r), sorts them by l and merges them into
// runs of rows, so that only rows a window covers take a slot in shared
// memory: the windows of a fine level overlap (a shared row takes one
// slot), those of a coarse level of the frame-level problem are narrow
// and far apart (the span between them takes none). It stages the slots
// of its channel tile with 16-byte cp.async copies (plain loads where x
// or the half is not 16-byte aligned) into a 16 KB buffer, in passes
// where they do not fit in one. Warps take windows, lanes take channels
// (four per lane, 32 apart: conflict-free shared-memory reads); the max
// is taken in float32 and stored as coalesced rows of out; with the
// argmax, strict `>` in ascending t keeps the first. The host shrinks
// the window tile (16, 8, then 4) until the grid has two blocks per SM:
// at B = 1 the frame-level problem has only 4 channel tiles, so it
// splits over k instead. Measured on an H100 (PERF.md), the 128-channel
// tile beat 64 channels, a 32 KB buffer, and a block that walks all the
// tiles of its half with double-buffered staging: at these sizes the
// time goes to each block's few dependent round trips (segments, rows,
// out), so many blocks that each move more bytes win.
//
// Backward design: the saved argmax, not x, is read (recomputing it as
// _bwd_kernel does would read every window of x again). One block per
// (batch row, channel tile of 32, level, tile of the level's rows), 4
// warps: warp w owns a band of rows and lane j channel j of the tile, in
// a float32 accumulator in shared memory that only that thread touches.
// The block stages the argmax and g of up to 128 of its level's windows
// (for one level with every window, as the frame-level problem, all k)
// in one cooperative round of 16-byte cp.async copies; then each thread
// walks them from shared memory in ascending k and adds g[b, k, c] where
// the argmax lands in its rows. So every dx element gets its adds in the
// order of the plain version, with no atomics and no race, and is
// rounded once to g's dtype. The band (16, 8, then 4 rows a warp)
// shrinks until the grid has two blocks per SM; the accumulator is at
// most 8 KB, whatever T is.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kWarps = 4;                  // 128 threads a block
constexpr int kThreads = kWarps * 32;
constexpr int kFwdChannels = 128;          // forward channel tile
constexpr int kFwdPerLane = kFwdChannels / 32;
constexpr int kFwdMaxWindows = 16;         // forward window tile, at most
constexpr int kFwdPerWarp = kFwdMaxWindows / kWarps;
constexpr int kFwdBufBytes = 16 * 1024;    // staging buffer
constexpr int kBwdChannels = 32;           // backward channel tile
constexpr int kBwdChunk = 128;             // windows staged at a time

// The level table, passed by value. tile_off[i] is the first blockIdx.y
// of level i (tiles of windows in the forward, of rows in the backward).
struct Levels {
  int n;
  int x_off[kMaxLevels + 1];
  int k_off[kMaxLevels + 1];
  int tile_off[kMaxLevels + 1];
};

__device__ __forceinline__ int level_of(const Levels& lv, int tile) {
  int i = 0;
  while (i + 1 < lv.n && lv.tile_off[i + 1] <= tile) ++i;
  return i;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, bool kArgmax>
__global__ void __launch_bounds__(kThreads)
    pool_fwd_kernel(const T* __restrict__ x, const float* __restrict__ seg,
                    T* __restrict__ out, int* __restrict__ argmax, Levels lv,
                    int t_total, int k_total, int channels, int k_tile,
                    int buf_rows, bool vec) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  T* buf = reinterpret_cast<T*>(stage_raw);  // (buf_rows, kFwdChannels)
  // window j reads slot t + win_base[j] for its row t; run r holds rows
  // run_row[r] .. at slots run_slot[r] .. run_slot[r + 1] - 1
  __shared__ int win_l[kFwdMaxWindows], win_r[kFwdMaxWindows];
  __shared__ int win_base[kFwdMaxWindows], order[kFwdMaxWindows];
  __shared__ int run_row[kFwdMaxWindows], run_slot[kFwdMaxWindows + 1];
  __shared__ int n_runs;

  const int half = channels / 2;
  const int tiles_per_half = (half + kFwdChannels - 1) / kFwdChannels;
  const int h = blockIdx.x / tiles_per_half;
  const int ch0 = h * half + (blockIdx.x % tiles_per_half) * kFwdChannels;
  const int n_ch = min(kFwdChannels, (h + 1) * half - ch0);
  const int lvl = level_of(lv, blockIdx.y);
  const int x_off = lv.x_off[lvl];
  const int t_len = lv.x_off[lvl + 1] - x_off;
  const int k0 = lv.k_off[lvl] + (blockIdx.y - lv.tile_off[lvl]) * k_tile;
  const int n_win = min(k_tile, lv.k_off[lvl + 1] - k0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the windows, sorted by l, merged into runs of rows: only rows that a
  // window covers take a slot (the windows of a tile may be disjoint)
  if (warp == 0) {
    int l = 0, r = 0;
    if (lane < n_win) {
      const float* s = seg + ((size_t)b * k_total + k0 + lane) * 4 + 2 * h;
      // __float2int_rz truncates toward zero like static_cast<int>, and
      // saturates instead of overflowing
      l = min(max(__float2int_rz(s[0]), 0), t_len - 1);
      r = min(max(__float2int_rz(s[1]), 0), t_len - 1);
      win_l[lane] = l;
      win_r[lane] = r = max(r, l);
    }
    __syncwarp();
    if (lane < n_win) {
      int rank = 0;
      for (int i = 0; i < n_win; ++i)
        rank += win_l[i] < l || (win_l[i] == l && i < lane);
      order[rank] = lane;
    }
    __syncwarp();
    if (lane == 0) {
      int nr = 0, slots = 0, end = -2;
      for (int q = 0; q < n_win; ++q) {
        const int j = order[q];
        if (win_l[j] > end + 1) {  // a new run
          run_row[nr] = win_l[j];
          run_slot[nr++] = slots;
          end = win_l[j] - 1;
        }
        win_base[j] = run_slot[nr - 1] - run_row[nr - 1];
        if (win_r[j] > end) {
          slots += win_r[j] - end;
          end = win_r[j];
        }
      }
      run_slot[nr] = slots;
      n_runs = nr;
    }
  }
  __syncthreads();

  float m[kFwdPerWarp][kFwdPerLane];
  int a[kFwdPerWarp][kFwdPerLane];
#pragma unroll
  for (int j = 0; j < kFwdPerWarp; ++j) {
    const int w = warp + j * kWarps;
#pragma unroll
    for (int e = 0; e < kFwdPerLane; ++e) {
      m[j][e] = __int_as_float(0xff800000);  // -inf
      a[j][e] = w < n_win ? win_l[w] : 0;
    }
  }

  // the slots in passes of at most buf_rows (one pass on the main path)
  const int n_slots = run_slot[n_runs];
  const T* xb = x + ((size_t)b * t_total + x_off) * channels + ch0;
  for (int s0 = 0; s0 < n_slots; s0 += buf_rows) {
    const int n_rows = min(buf_rows, n_slots - s0);
    if (vec) {
      constexpr int kPer = 16 / sizeof(T);           // values a piece
      constexpr int kPieces = kFwdChannels / kPer;   // pieces a row
      for (int i = threadIdx.x; i < n_rows * kPieces; i += kThreads) {
        const int slot = s0 + i / kPieces, p = (i % kPieces) * kPer;
        int run = 0;
        while (run + 1 < n_runs && run_slot[run + 1] <= slot) ++run;
        cp_async16(buf + (slot - s0) * kFwdChannels + p,
                   xb + (size_t)(run_row[run] + slot - run_slot[run]) *
                            channels + p);
      }
      cp_async_wait_all();
    } else {
      for (int i = threadIdx.x; i < n_rows * n_ch; i += kThreads) {
        const int slot = s0 + i / n_ch, c = i % n_ch;
        int run = 0;
        while (run + 1 < n_runs && run_slot[run + 1] <= slot) ++run;
        buf[(slot - s0) * kFwdChannels + c] =
            xb[(size_t)(run_row[run] + slot - run_slot[run]) * channels + c];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kFwdPerWarp; ++j) {
      const int w = warp + j * kWarps;
      if (w < n_win) {
        const int base = win_base[w];
        const int t1 = min(win_r[w], s0 + n_rows - 1 - base);
        for (int t = max(win_l[w], s0 - base); t <= t1; ++t) {
          const T* row = buf + (t + base - s0) * kFwdChannels + lane;
#pragma unroll
          for (int e = 0; e < kFwdPerLane; ++e) {
            const float v = to_f(row[32 * e]);
            if (kArgmax) {
              if (v > m[j][e]) {  // strict: the first t attaining the max
                m[j][e] = v;
                a[j][e] = t;
              }
            } else {
              m[j][e] = fmaxf(m[j][e], v);
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kFwdPerWarp; ++j) {
    const int w = warp + j * kWarps;
    if (w < n_win) {
      const size_t o = ((size_t)b * k_total + k0 + w) * channels + ch0;
#pragma unroll
      for (int e = 0; e < kFwdPerLane; ++e) {
        const int c = lane + 32 * e;
        if (c < n_ch) {
          store_f(out + o + c, m[j][e]);
          if (kArgmax) argmax[o + c] = x_off + a[j][e];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_bwd_kernel(const int* __restrict__ argmax, const T* __restrict__ g,
                    T* __restrict__ dx, Levels lv, int t_total, int k_total,
                    int channels, int rows_per_warp, bool vec) {
  extern __shared__ float acc[];  // (kWarps * rows_per_warp, 32)
  __shared__ __align__(16) int am_s[kBwdChunk][kBwdChannels];
  __shared__ __align__(16) T g_s[kBwdChunk][kBwdChannels];
  const int lvl = level_of(lv, blockIdx.y);
  const int x_off = lv.x_off[lvl];
  const int t_len = lv.x_off[lvl + 1] - x_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this thread's rows of the level: [r0, r0 + rows_per_warp)
  const int r0 =
      ((blockIdx.y - lv.tile_off[lvl]) * kWarps + warp) * rows_per_warp;
  const int c0 = blockIdx.x * kBwdChannels;
  const int b = blockIdx.z;
  const bool mine = c0 + lane < channels && r0 < t_len;
  float* my = acc + warp * rows_per_warp * 32 + lane;  // bank = lane
  for (int r = 0; r < rows_per_warp; ++r) my[r * 32] = 0.0f;
  const int first = x_off + r0;  // packed row of my[0]
  for (int kc = lv.k_off[lvl]; kc < lv.k_off[lvl + 1]; kc += kBwdChunk) {
    // the chunk's argmax and g rows of this channel tile, all at once
    const int n = min(kBwdChunk, lv.k_off[lvl + 1] - kc);
    const size_t row0 = ((size_t)b * k_total + kc) * channels + c0;
    if (vec) {
      constexpr int kAm = kBwdChannels * 4 / 16;           // pieces a row
      constexpr int kG = kBwdChannels * sizeof(T) / 16;
      for (int i = threadIdx.x; i < n * (kAm + kG); i += kThreads) {
        if (i < n * kAm) {
          const int k = i / kAm, p = (i % kAm) * 4;
          cp_async16(&am_s[k][p], argmax + row0 + (size_t)k * channels + p);
        } else {
          const int j = i - n * kAm, k = j / kG;
          const int p = (j % kG) * (16 / sizeof(T));
          cp_async16(&g_s[k][p], g + row0 + (size_t)k * channels + p);
        }
      }
      cp_async_wait_all();
    } else {
      const int n_ch = min(kBwdChannels, channels - c0);
      for (int i = threadIdx.x; i < n * kBwdChannels; i += kThreads) {
        const int k = i / kBwdChannels, c = i % kBwdChannels;
        if (c < n_ch) {
          am_s[k][c] = argmax[row0 + (size_t)k * channels + c];
          g_s[k][c] = g[row0 + (size_t)k * channels + c];
        }
      }
    }
    __syncthreads();
    if (mine) {
      for (int k = 0; k < n; ++k) {
        const unsigned d = static_cast<unsigned>(am_s[k][lane] - first);
        if (d < static_cast<unsigned>(rows_per_warp))
          my[d * 32] += to_f(g_s[k][lane]);
      }
    }
    __syncthreads();
  }
  if (!mine) return;
  T* dp = dx + ((size_t)b * t_total + first) * channels + c0 + lane;
  const int n = min(rows_per_warp, t_len - r0);
  for (int r = 0; r < n; ++r, dp += channels) store_f(dp, my[r * 32]);
}

int two_blocks_per_sm() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return 2 * sms;
}

// Fills lv from the sizes (validated: 1 <= n <= kMaxLevels, sums equal
// the totals, t_i >= 1 where k_i >= 1); tiles of `tile` along `by`
// (k_sizes for the forward, t_sizes for the backward). false if invalid.
bool make_levels(Levels* lv, const int* t_sizes, const int* k_sizes, int n,
                 int t_total, int k_total, const int* by, int tile) {
  if (n < 1 || n > kMaxLevels) return false;
  lv->n = n;
  lv->x_off[0] = lv->k_off[0] = lv->tile_off[0] = 0;
  for (int i = 0; i < n; ++i) {
    if (t_sizes[i] < 0 || k_sizes[i] < 0 || (k_sizes[i] > 0 && t_sizes[i] < 1))
      return false;
    lv->x_off[i + 1] = lv->x_off[i] + t_sizes[i];
    lv->k_off[i + 1] = lv->k_off[i] + k_sizes[i];
    lv->tile_off[i + 1] = lv->tile_off[i] + (by[i] + tile - 1) / tile;
  }
  return lv->x_off[n] == t_total && lv->k_off[n] == k_total;
}

template <typename T>
int launch_fwd(const void* x, const float* seg, void* out, int* am, int b,
               int t_total, int channels, int k_total, const int* t_sizes,
               const int* k_sizes, int n, cudaStream_t stream) {
  const int half = channels / 2;
  const int ch_tiles = 2 * ((half + kFwdChannels - 1) / kFwdChannels);
  const int want = two_blocks_per_sm();
  Levels lv;
  int k_tile = kFwdMaxWindows;
  for (;;) {
    if (!make_levels(&lv, t_sizes, k_sizes, n, t_total, k_total, k_sizes,
                     k_tile))
      return (int)cudaErrorInvalidValue;
    if (k_tile == 4 || (long long)b * ch_tiles * lv.tile_off[n] >= want)
      break;
    k_tile /= 2;
  }
  const int tiles = lv.tile_off[n];
  if (tiles == 0) return 0;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  int t_max = 1;
  for (int i = 0; i < n; ++i) t_max = max(t_max, t_sizes[i]);
  const int buf_rows =
      min(t_max, kFwdBufBytes / (int)(kFwdChannels * sizeof(T)));
  const size_t smem = (size_t)buf_rows * kFwdChannels * sizeof(T);
  const bool vec = half % kFwdChannels == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid(ch_tiles, tiles, b);
  if (am != nullptr) {
    pool_fwd_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), seg, static_cast<T*>(out), am, lv, t_total,
        k_total, channels, k_tile, buf_rows, vec);
  } else {
    pool_fwd_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), seg, static_cast<T*>(out), nullptr, lv,
        t_total, k_total, channels, k_tile, buf_rows, vec);
  }
  return 0;
}

template <typename T>
int launch_bwd(const int* argmax, const void* g, void* dx, int b,
               int t_total, int channels, int k_total, const int* t_sizes,
               const int* k_sizes, int n, cudaStream_t stream) {
  const int c_tiles = (channels + kBwdChannels - 1) / kBwdChannels;
  const int want = two_blocks_per_sm();
  Levels lv;
  int rows_per_warp = 16;
  for (;;) {
    if (!make_levels(&lv, t_sizes, k_sizes, n, t_total, k_total, t_sizes,
                     kWarps * rows_per_warp))
      return (int)cudaErrorInvalidValue;
    if (rows_per_warp == 4 ||
        (long long)b * c_tiles * lv.tile_off[n] >= want)
      break;
    rows_per_warp /= 2;
  }
  const int tiles = lv.tile_off[n];
  if (tiles == 0) return 0;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * rows_per_warp * 32 * sizeof(float);
  const bool vec = channels % kBwdChannels == 0 &&
                   reinterpret_cast<uintptr_t>(argmax) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  dim3 grid(c_tiles, tiles, b);
  pool_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      argmax, static_cast<const T*>(g), static_cast<T*>(dx), lv, t_total,
      k_total, channels, rows_per_warp, vec);
  return 0;
}

}  // namespace

// out (B, K, C) [and the int32 packed argmax (B, K, C), or null for the
// inference forward] from x (B, T, C) and segments (B, K, 4) float32,
// over the level table t_sizes / k_sizes (n_levels entries, host
// memory). dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a table
// or grid it does not take; does not synchronise.
extern "C" int boundary_max_pool_fwd(const void* x, const void* seg,
                                     void* out, void* argmax, int b,
                                     int t_total, int channels, int k_total,
                                     const int* t_sizes, const int* k_sizes,
                                     int n_levels, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* am = static_cast<int*>(argmax);
  const float* s = static_cast<const float*>(seg);
  if (b > 65535) return (int)cudaErrorInvalidValue;
  int err;
  if (dtype == 0) {
    err = launch_fwd<float>(x, s, out, am, b, t_total, channels, k_total,
                            t_sizes, k_sizes, n_levels, st);
  } else if (dtype == 1) {
    err = launch_fwd<__nv_bfloat16>(x, s, out, am, b, t_total, channels,
                                    k_total, t_sizes, k_sizes, n_levels, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// dx (B, T, C) in g's dtype from the packed argmax (B, K, C) int32 and
// g (B, K, C), over the same level table. dtype and return as above.
extern "C" int boundary_max_pool_bwd(const void* argmax, const void* g,
                                     void* dx, int b, int t_total,
                                     int channels, int k_total,
                                     const int* t_sizes, const int* k_sizes,
                                     int n_levels, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* am = static_cast<const int*>(argmax);
  if (b > 65535) return (int)cudaErrorInvalidValue;
  int err;
  if (dtype == 0) {
    err = launch_bwd<float>(am, g, dx, b, t_total, channels, k_total,
                            t_sizes, k_sizes, n_levels, st);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(am, g, dx, b, t_total, channels, k_total,
                                    t_sizes, k_sizes, n_levels, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
