// The MoE's token movement of a prefill on an NVIDIA Hopper card (sm_90a):
// the dispatch of each token's row into the (E, C, d) expert buffer and
// the gated combine of the experts' rows back into token order.
//
// Replaces no Pallas kernel: the reference's dispatch and combine are
// plain JAX (src/repro/models/moe.py), and so were the port's
// (src/repro_torch/models/moe.py `_scatter`, `_combine`), which at
// Granite 4.0-H Small's E = 72, top-k = 10, d = 4096 and 8192 tokens moved
// about 11 GB a layer: an expanded (T k, d) copy, its permutation, a
// zeroed (E C + 1, d) buffer and an `index_put` to dispatch; a `cat` of the
// whole buffer, a gather, a gate pass, a second argsort and a permutation
// to combine.  These kernels compute the same functions, with the same
// bits in the buffer and the same rounding points in y:
//
//   dispatch: order, dest (T k,) int64 from `moe.dispatch` (sorted
//     assignment i is (token, slot) order[i], at buffer row dest[i], or
//     dropped when dest[i] >= E C) -> buf (E C, d) with row dest[i] =
//     x[order[i] / k] and every row past an expert's fill zero, and the
//     map slot_row (T k,) int32 from each (token, slot) to its buffer row,
//     -1 where the assignment was dropped;
//   combine: out (E C, d), slot_row and the gates (T, k) float32 -> y (T,
//     d) = sum over slots j = 0 .. k-1, in that order in float32, of the
//     product out[row] * g rounded to the row's type (g itself rounded to
//     it first), y rounded once; a dropped slot adds nothing.  No atomics:
//     y has the same bits on every run.
//
// Bound: bytes.  At Granite's 8192 tokens the dispatch writes the 840 MB
// buffer (empty rows included) and reads x (67 MB) and the indices; the
// combine reads the kept rows (about 641 MB at 4.5 % dropped) and writes
// y (67 MB): about 0.27 and 0.21 ms at 3.35 TB/s, against no arithmetic to
// speak of.  What the design does about it:
//
//   * each row moves as 16-byte vectors, the lanes of a warp on
//     neighbouring vectors of one row (a row is 8 KB at d = 4096);
//   * the dispatch walks tokens, not buffer rows: a warp reads its token's
//     row once and writes it to each of the token's kept rows, so x is
//     read once and not once a slot (x exceeds the 50 MB L2 there, and a
//     token's k rows lie thousands of rows apart); rows past an expert's
//     fill are zeroed by the same launch, so every buffer row is written
//     exactly once and nothing is zero-filled first;
//   * a small first kernel inverts the sort into slot_row (and each
//     expert's fill, from its last kept assignment); that is what lets the
//     row pass walk tokens, and it replaces the combine's argsort and its
//     permutation;
//   * the combine's warp issues the loads of up to 8 slots x 2 vectors
//     (16 loads of 16 bytes a lane) before it sums any, then sums them in
//     slot order;
//   * plain vector loads, not TMA bulk copies: a row is one contiguous
//     run the vectors already cover at full width, and neither kernel
//     reuses what it loads, so staging it in shared memory would add a
//     trip and save none;
//   * a persistent grid of as many blocks as the card holds at once (132
//     SMs times the blocks an SM fits), each warp striding over the work:
//     the dispatch's heavy token items first, then the rows to zero.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps a block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kCopyVecs = 4;            // vectors a lane holds in a dispatch
constexpr int kSlots = 8;               // slots whose loads a combine issues
constexpr int kSumVecs = 2;             // vectors a lane sums at a time

// Sorted assignment i -> slot_row[order[i]] (its row, or -1 if dropped);
// the last kept assignment of an expert sets fill[e], its kept count (an
// expert's kept rows are e C + 0, 1, ... at consecutive i, so the next
// assignment is the next row unless this one is the last kept: the next
// is dropped, another expert's, or this one filled row C - 1).
__global__ void __launch_bounds__(kThreads)
moe_rows_index(const int64_t* __restrict__ order,
               const int64_t* __restrict__ dest, int n, int C, int64_t rows,
               int* __restrict__ slot_row, int* __restrict__ fill) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = dest[i];
  const bool kept = r >= 0 && r < rows;
  slot_row[order[i]] = kept ? (int)r : -1;
  if (kept) {
    const int p = (int)(r % C);
    if (p == C - 1 || i == n - 1 || dest[i + 1] != r + 1)
      fill[r / C] = p + 1;
  }
}

// Items 0 .. T-1: token t's row, read once, to each of its kept rows;
// items T .. T + E C - 1: buffer row r zeroed if it lies past its expert's
// fill.  A warp an item; `vecs` 16-byte vectors a row.
__global__ void __launch_bounds__(kThreads)
moe_rows_dispatch(const uint4* __restrict__ x, int64_t x_row,
                  uint4* __restrict__ buf, int vecs, int T, int k, int C,
                  int64_t rows, const int* __restrict__ slot_row,
                  const int* __restrict__ fill) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const int64_t items = T + rows;
  for (int64_t it = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       it < items; it += warps) {
    if (it < T) {
      const uint4* src = x + it * x_row;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int nj = min(32, k - j0);
        const int mine = lane < nj ? slot_row[it * k + j0 + lane] : -1;
        if (!__any_sync(kAll, mine >= 0)) continue;
        for (int c0 = 0; c0 < vecs; c0 += 32 * kCopyVecs) {
          uint4 v[kCopyVecs];
#pragma unroll
          for (int u = 0; u < kCopyVecs; ++u) {
            const int c = c0 + u * 32 + lane;
            if (c < vecs) v[u] = src[c];
          }
          for (int j = 0; j < nj; ++j) {
            const int r = __shfl_sync(kAll, mine, j);
            if (r < 0) continue;
            uint4* dst = buf + (int64_t)r * vecs;
#pragma unroll
            for (int u = 0; u < kCopyVecs; ++u) {
              const int c = c0 + u * 32 + lane;
              if (c < vecs) dst[c] = v[u];
            }
          }
        }
      }
    } else {
      const int64_t r = it - T;
      if (r % C < fill[r / C]) continue;       // a kept row: a token's
      uint4* dst = buf + r * vecs;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int c = lane; c < vecs; c += 32) dst[c] = zero;
    }
  }
}

// The 16-bit row types: a 16-byte vector is 4 pairs.
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ float2 to_float2(type v) { return __bfloat1622float2(v); }
  static __device__ type from_float2(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ float round(float a) {
    return __bfloat162float(__float2bfloat16_rn(a));
  }
};
template <> struct Pair<__half> {
  using type = __half2;
  static __device__ float2 to_float2(type v) { return __half22float2(v); }
  static __device__ type from_float2(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  static __device__ float round(float a) {
    return __half2float(__float2half_rn(a));
  }
};

// y[t] = sum_j round(out[slot_row[t k + j]] * round(g[t k + j])) in float32
// over j = 0 .. k-1 in order, rounded once.  A warp a token.
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_rows_combine(const uint4* __restrict__ out, int vecs,
                 const int* __restrict__ slot_row,
                 const float* __restrict__ gates, int ntok, int k,
                 uint4* __restrict__ y) {
  using P = Pair<T>;
  using T2 = typename P::type;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < ntok; t += warps) {
    for (int c0 = 0; c0 < vecs; c0 += 32 * kSumVecs) {
      float acc[kSumVecs][8];
#pragma unroll
      for (int u = 0; u < kSumVecs; ++u)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[u][e] = 0.0f;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int nj = min(32, k - j0);
        const int mine = lane < nj ? slot_row[t * k + j0 + lane] : -1;
        const float gate = lane < nj ? gates[t * k + j0 + lane] : 0.0f;
        for (int jg = 0; jg < nj; jg += kSlots) {
          uint4 v[kSlots][kSumVecs];
          int r[kSlots];
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            r[s] = __shfl_sync(kAll, mine, (jg + s) & 31);
            if (jg + s >= nj) r[s] = -1;
#pragma unroll
            for (int u = 0; u < kSumVecs; ++u) {
              const int c = c0 + u * 32 + lane;
              if (r[s] >= 0 && c < vecs) v[s][u] = out[(int64_t)r[s] * vecs + c];
            }
          }
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const float g = P::round(__shfl_sync(kAll, gate, (jg + s) & 31));
            if (r[s] < 0) continue;
#pragma unroll
            for (int u = 0; u < kSumVecs; ++u) {
              const T2* h = reinterpret_cast<const T2*>(&v[s][u]);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = P::to_float2(h[e]);
                acc[u][2 * e] += P::round(f.x * g);
                acc[u][2 * e + 1] += P::round(f.y * g);
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSumVecs; ++u) {
        const int c = c0 + u * 32 + lane;
        if (c >= vecs) continue;
        uint4 o;
        T2* h = reinterpret_cast<T2*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] = P::from_float2(acc[u][2 * e], acc[u][2 * e + 1]);
        y[t * vecs + c] = o;
      }
    }
  }
}

// Blocks of a persistent grid: as many as the card holds at once (cached
// a device), no more than `need`.
template <typename K>
int grid_for(K kernel, int64_t need) {
  static int resident[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 0;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return (int)(need < resident[dev] ? need : resident[dev]);
}

}  // namespace

// The dispatch of one MoE layer on `stream`: fill (E ints of `scratch`,
// after the T k of slot_row) zeroed, then the index kernel, then the row
// kernel.  x: T rows of `row_bytes` (a multiple of 16), `x_row_bytes`
// apart, 16-byte aligned; order, dest: T k int64; buf: E C rows, dense;
// scratch: T k + E ints, slot_row first.  Returns a cudaError_t (0 =
// launched).
extern "C" int moe_dispatch_rows(const void* x, int64_t x_row_bytes,
                                 const void* order, const void* dest,
                                 void* buf, void* scratch, int T, int k,
                                 int E, int C, int row_bytes, void* stream) {
  if (T < 0 || k < 1 || E < 1 || C < 1 || row_bytes < 16 ||
      row_bytes % 16 != 0 || x_row_bytes % 16 != 0 ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)buf % 16 != 0 ||
      (int64_t)T * k >= INT32_MAX || (int64_t)E * C >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = T * k;
  const int64_t rows = (int64_t)E * C;
  int* slot_row = (int*)scratch;
  int* fill = slot_row + n;
  cudaError_t err = cudaMemsetAsync(fill, 0, sizeof(int) * E, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    moe_rows_index<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const int64_t*)order, (const int64_t*)dest, n, C, rows, slot_row,
        fill);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = grid_for(moe_rows_dispatch,
                            (T + rows + kWarps - 1) / kWarps);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  moe_rows_dispatch<<<grid, kThreads, 0, s>>>(
      (const uint4*)x, x_row_bytes / 16, (uint4*)buf, row_bytes / 16, T, k,
      C, rows, slot_row, fill);
  return (int)cudaGetLastError();
}

// The combine of one MoE layer on `stream`.  out: dense rows of
// `row_bytes` (a multiple of 16), 16-byte aligned; slot_row: T k ints;
// gates: T k float32; y: T dense rows.  `half` 0: bfloat16 rows, 1:
// float16.  Returns a cudaError_t (0 = launched).
extern "C" int moe_combine_rows(const void* out, const void* slot_row,
                                const void* gates, void* y, int T, int k,
                                int row_bytes, int half, void* stream) {
  if (T < 0 || k < 1 || row_bytes < 16 || row_bytes % 16 != 0 ||
      (uintptr_t)out % 16 != 0 || (uintptr_t)y % 16 != 0 ||
      (int64_t)T * k >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int vecs = row_bytes / 16;
  const int need = (T + kWarps - 1) / kWarps;
  if (half) {
    const int grid = grid_for(moe_rows_combine<__half>, need);
    if (grid < 1) return (int)cudaErrorInvalidConfiguration;
    moe_rows_combine<__half><<<grid, kThreads, 0, s>>>(
        (const uint4*)out, vecs, (const int*)slot_row, (const float*)gates,
        T, k, (uint4*)y);
  } else {
    const int grid = grid_for(moe_rows_combine<__nv_bfloat16>, need);
    if (grid < 1) return (int)cudaErrorInvalidConfiguration;
    moe_rows_combine<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const uint4*)out, vecs, (const int*)slot_row, (const float*)gates,
        T, k, (uint4*)y);
  }
  return (int)cudaGetLastError();
}
