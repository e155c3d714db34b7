// Soft-NMS for Hopper (sm_90a): the whole greedy pick loop of every row
// in one launch.
//
// Replaces no TPU kernel: the JAX package runs soft-NMS as one
// lax.while_loop that XLA compiles whole (opental_tpu/ops/nms.py,
// soft_nms_device). Eager PyTorch has no such loop: the port's plain
// version (opental_torch/ops/nms.py, soft_nms_plain) launches ~34 small
// kernels a pick, each microseconds of host dispatch for nanoseconds of
// work, and the card waits on Python for every pick. This kernel keeps
// the loop on the card.
//
// Contract (ops/soft_nms_cuda.py): seg (rows, N, D) float32 row-major,
// D >= 3 columns [start, end, score, extras...]; valid (rows, N) bytes
// 0 / 1, or null for all valid; out (rows, N, D + 1) float32: the row's
// columns with the scores as the loop left them and a kept flag (1 or 0)
// appended; counts (rows,) int64, the picks of each row. Per row, the
// plain loop's recursion in its f32 arithmetic:
//   undone = score >= thr and valid
//   while (count of undone > 1 and picks < top_k):
//     i = argmax of score over undone (the lowest index among ties)
//     undone[i] = 0, kept[i] = 1, picks += 1
//     for j undone: inter = max(min(e_j, e_i) - max(s_j, s_i), 0)
//                   iou = inter / ((max(e_i - s_i, 1e-5) + (e_j - s_j))
//                                  - inter)
//                   score_j *= exp(-(iou * iou) * (1 / sigma))
//                   undone[j] = score_j >= thr
// PyTorch divides a tensor by a Python scalar on the card as a product
// with the scalar's reciprocal (taken in double, rounded to float), and
// so does this kernel, handed that reciprocal: the decay and hence the
// picks equal the plain loop's on the card bit for bit.
// Every operation is rounded on its own (the __f*_rn intrinsics: no
// contraction into FMAs), and expf is the accurate one (no fast math).
//
// What bounds it: latency, not bytes. The picks of a row depend on each
// other, up to min(N - 1, top_k) of them, and each is one block-wide
// argmax (one barrier) and a pass over the row. The bytes, N x D read
// and N x (D + 1) written once, take microseconds.
//
// Design: one block per row. Thread t owns candidates t, t + T, t + 2T,
// ... (EPT of them, EPT in {1, 2, 4, 8}, so at most 8192 a row with
// 1024 threads), whose start, end and score stay in registers, and whose
// undone and kept flags are bits of two registers, for the whole loop;
// start and end are also in shared memory, where every thread reads the
// pick's. Each pick: a thread's best undone candidate (the ordered bits
// of its score, the complement of its index) and its undone count are
// reduced in the warp by three redux.sync (max of the score bits, max of
// the complemented index among the lanes that hold that score, sum of
// the counts); lane 0 writes the warp's partial into a slot of a
// double buffer chosen by the pick's parity; one __syncthreads; then
// every warp reduces the partials the same way, so every thread knows
// the pick and whether the row goes on without a second barrier (a slot
// is written again only two picks later, after the next barrier, which
// every reader of it has passed). Then each thread decays its own
// undone candidates against the pick, in registers.
//
// Rows of more than 8192 candidates (a class's whole block on the host
// path's `device_nms`, padded to a power of two) take the same loop with
// the row in `out` instead of registers (soft_nms_wide_kernel): out is
// filled first, its flag column holding 2 for undone, 1 for kept and 0
// otherwise, and each pick's pass decays a thread's own candidates there
// and finds its best undone one for the next pick in the same pass. A
// candidate's score and flag are read and written by its own thread
// only; the pick's start and end, written before the first barrier, are
// read by all. The row stays in L2; a pick costs a pass over it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxEpt = 8;
constexpr unsigned kFull = 0xffffffffu;

// A float's bits as an unsigned in the float's order (negatives flipped,
// -0 as +0), so an unsigned max is the float max; every non-NaN float
// maps above 0, which marks "no candidate". An undone score is never
// NaN: NaN >= thr is false.
__device__ __forceinline__ unsigned ordered(float x) {
  unsigned b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The block's best (score bits, complemented index) and undone count
// from every thread's own: three redux.sync a warp, one barrier, three
// more over the warps' partials in slot buffer `parity`.
struct Best {
  unsigned hi, lo, count;
};

__device__ __forceinline__ Best block_best(unsigned hi, unsigned lo,
                                           unsigned count, int parity,
                                           unsigned (*slots)[3][kMaxWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned h = __reduce_max_sync(kFull, hi);
  unsigned l = __reduce_max_sync(kFull, hi == h ? lo : 0u);
  unsigned c = __reduce_add_sync(kFull, count);
  if (lane == 0) {
    slots[parity][0][warp] = h;
    slots[parity][1][warp] = l;
    slots[parity][2][warp] = c;
  }
  __syncthreads();
  hi = lane < warps ? slots[parity][0][lane] : 0u;
  lo = lane < warps ? slots[parity][1][lane] : 0u;
  count = lane < warps ? slots[parity][2][lane] : 0u;
  Best b;
  b.hi = __reduce_max_sync(kFull, hi);
  b.lo = __reduce_max_sync(kFull, hi == b.hi ? lo : 0u);
  b.count = __reduce_add_sync(kFull, count);
  return b;
}

template <int EPT>
__global__ void __launch_bounds__(kMaxThreads)
soft_nms_kernel(const float* __restrict__ seg,
                const unsigned char* __restrict__ valid,
                float* __restrict__ out, long long* __restrict__ counts,
                int n, int d, int top_k, float inv_sigma, float thr) {
  extern __shared__ float coords[];          // start[n], then end[n]
  __shared__ unsigned slots[2][3][kMaxWarps];
  float* sh_start = coords;
  float* sh_end = coords + n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row = blockIdx.x;
  const float* rs = seg + row * n * d;

  float s[EPT], e[EPT], sc[EPT];
  unsigned undone = 0u, kept = 0u;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int i = tid + j * nt;
    s[j] = e[j] = sc[j] = 0.0f;
    if (i < n) {
      const float* r = rs + (size_t)i * d;
      s[j] = r[0];
      e[j] = r[1];
      sc[j] = r[2];
      sh_start[i] = s[j];
      sh_end[i] = e[j];
      const bool ok = valid == nullptr || valid[row * n + i];
      if (ok && sc[j] >= thr) undone |= 1u << j;
    }
  }

  int picks = 0;
  for (int parity = 0;; parity ^= 1) {
    // this thread's best undone candidate and undone count; j ascending
    // is index ascending, so `>` keeps the lowest index among ties
    unsigned hi = 0u, lo = 0u, count = 0u;
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      if (undone >> j & 1u) {
        const unsigned h = ordered(sc[j]);
        if (h > hi) {
          hi = h;
          lo = ~(unsigned)(tid + j * nt);
        }
        ++count;
      }
    }
    const Best b = block_best(hi, lo, count, parity, slots);
    if (b.count <= 1u || picks >= top_k) break;
    ++picks;
    const int pick = (int)~b.lo;
    const float s_i = sh_start[pick], e_i = sh_end[pick];
    const float width = fmaxf(__fsub_rn(e_i, s_i), 1e-5f);
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      if (tid + j * nt == pick) {
        undone &= ~(1u << j);
        kept |= 1u << j;
      }
      if (undone >> j & 1u) {
        const float inter = fmaxf(
            __fsub_rn(fminf(e[j], e_i), fmaxf(s[j], s_i)), 0.0f);
        const float length = __fsub_rn(e[j], s[j]);
        const float iou =
            __fdiv_rn(inter, __fsub_rn(__fadd_rn(width, length), inter));
        const float decay = expf(__fmul_rn(-__fmul_rn(iou, iou), inv_sigma));
        sc[j] = __fmul_rn(sc[j], decay);
        if (!(sc[j] >= thr)) undone &= ~(1u << j);
      }
    }
  }

  float* ro = out + row * n * (d + 1);
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int i = tid + j * nt;
    if (i < n) {
      float* o = ro + (size_t)i * (d + 1);
      const float* r = rs + (size_t)i * d;
      o[0] = s[j];
      o[1] = e[j];
      o[2] = sc[j];
      for (int c = 3; c < d; ++c) o[c] = r[c];
      o[d] = (kept >> j & 1u) ? 1.0f : 0.0f;
    }
  }
  if (tid == 0) counts[row] = picks;
}

__global__ void __launch_bounds__(kMaxThreads)
soft_nms_wide_kernel(const float* __restrict__ seg,
                     const unsigned char* __restrict__ valid, float* out,
                     long long* __restrict__ counts, int n, int d, int top_k,
                     float inv_sigma, float thr) {
  __shared__ unsigned slots[2][3][kMaxWarps];
  const int tid = threadIdx.x, nt = blockDim.x, d1 = d + 1;
  const size_t row = blockIdx.x;
  const float* rs = seg + row * n * d;
  float* ro = out + row * n * d1;
  constexpr float kUndone = 2.0f, kKept = 1.0f;

  // index ascending within a thread, so `>` keeps the lowest among ties
  unsigned hi = 0u, lo = 0u, count = 0u;
  for (int i = tid; i < n; i += nt) {
    const float* r = rs + (size_t)i * d;
    float* o = ro + (size_t)i * d1;
    for (int c = 0; c < d; ++c) o[c] = r[c];
    const bool ok = valid == nullptr || valid[row * n + i];
    const bool undone = ok && r[2] >= thr;
    o[d] = undone ? kUndone : 0.0f;
    if (undone) {
      const unsigned h = ordered(r[2]);
      if (h > hi) {
        hi = h;
        lo = ~(unsigned)i;
      }
      ++count;
    }
  }

  int picks = 0;
  for (int parity = 0;; parity ^= 1) {
    const Best b = block_best(hi, lo, count, parity, slots);
    if (b.count <= 1u || picks >= top_k) break;
    ++picks;
    const int pick = (int)~b.lo;
    const float s_i = ro[(size_t)pick * d1], e_i = ro[(size_t)pick * d1 + 1];
    const float width = fmaxf(__fsub_rn(e_i, s_i), 1e-5f);
    hi = lo = count = 0u;
    for (int i = tid; i < n; i += nt) {
      float* o = ro + (size_t)i * d1;
      if (o[d] != kUndone) continue;
      if (i == pick) {
        o[d] = kKept;
        continue;
      }
      const float s = o[0], e = o[1];
      const float inter =
          fmaxf(__fsub_rn(fminf(e, e_i), fmaxf(s, s_i)), 0.0f);
      const float length = __fsub_rn(e, s);
      const float iou =
          __fdiv_rn(inter, __fsub_rn(__fadd_rn(width, length), inter));
      const float decay = expf(__fmul_rn(-__fmul_rn(iou, iou), inv_sigma));
      const float sc = __fmul_rn(o[2], decay);
      o[2] = sc;
      if (!(sc >= thr)) {
        o[d] = 0.0f;
        continue;
      }
      const unsigned h = ordered(sc);
      if (h > hi) {
        hi = h;
        lo = ~(unsigned)i;
      }
      ++count;
    }
  }

  for (int i = tid; i < n; i += nt) {
    float* o = ro + (size_t)i * d1;
    if (o[d] == kUndone) o[d] = 0.0f;
  }
  if (tid == 0) counts[row] = picks;
}

template <int EPT>
int launch(const float* seg, const unsigned char* valid, float* out,
           long long* counts, int rows, int n, int d, int top_k,
           float inv_sigma, float thr, int threads, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        soft_nms_kernel<EPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  soft_nms_kernel<EPT><<<rows, threads, smem, stream>>>(
      seg, valid, out, counts, n, d, top_k, inv_sigma, thr);
  return 0;
}

}  // namespace

// out (rows, n, d + 1) and counts (rows,) from seg (rows, n, d) and valid
// (rows, n) or null, on `stream`; inv_sigma is 1 / sigma. A thread
// holds the fewest candidates (1, 2, 4 or 8) that fit n in 1024 threads:
// the widest block, which was the fastest on an H100 (PERF.md); longer
// rows take the wide kernel. Returns 0 or a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int soft_nms(const void* seg, const void* valid, void* out,
                        void* counts, int rows, int n, int d, int top_k,
                        float inv_sigma, float thr, void* stream) {
  if (rows <= 0 || n < 0 || d < 3) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(seg);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  float* o = static_cast<float*>(out);
  long long* c = static_cast<long long*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > kMaxEpt * kMaxThreads) {
    soft_nms_wide_kernel<<<rows, kMaxThreads, 0, st>>>(
        s, v, o, c, n, d, top_k, inv_sigma, thr);
    return (int)cudaGetLastError();
  }
  int ept = 1;
  while (n > ept * kMaxThreads) ept *= 2;
  int threads = (n + ept - 1) / ept;
  threads = threads < 32 ? 32 : (threads + 31) / 32 * 32;
  int err;
  switch (ept) {
    case 1:
      err = launch<1>(s, v, o, c, rows, n, d, top_k, inv_sigma, thr, threads,
                      st);
      break;
    case 2:
      err = launch<2>(s, v, o, c, rows, n, d, top_k, inv_sigma, thr, threads,
                      st);
      break;
    case 4:
      err = launch<4>(s, v, o, c, rows, n, d, top_k, inv_sigma, thr, threads,
                      st);
      break;
    default:
      err = launch<8>(s, v, o, c, rows, n, d, top_k, inv_sigma, thr, threads,
                      st);
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
