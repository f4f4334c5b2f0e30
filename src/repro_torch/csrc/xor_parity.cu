// XOR parity of K int32 rows on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel `_xor_kernel` of
// src/repro/kernels/parity.py (reached through `xor_parity` and
// `reconstruct`): K rows of N int32 -> (N,) int32, out[j] = x[0][j] ^ ...
// ^ x[K-1][j], bit-exact, for any K >= 1 and N >= 1.  raid5 parity is this
// function over a stripe round's data units; a lost unit is this function
// over the survivors and the parity.
//
// Bound: memory.  The kernel reads K*N*4 bytes, writes N*4 bytes and does
// (K-1)*N integer XORs, far below one operation per byte, so the least
// time is (K+1)*N*4 bytes over 3.35 TB/s: 1.565 us for K=4, N=262144 (one
// 1 MiB stripe unit a row), the main path's call.  At 5 MiB a call the
// fixed cost of a launch and the latency of the first loads are a large
// part of that, so the design puts every byte of the call in flight at
// once, in one wave of equal blocks:
//
//   * equal work, one wave: the columns are cut into contiguous spans of
//     equal size, one span a block, at most as many blocks as the SMs hold
//     at once (and a multiple of the SM count), so no SM gets twice the
//     work of another and no block waits for a second wave;
//   * the rows are passed as pointers (up to kMaxRows in the parameter
//     struct, by value), so `reconstruct` XORs the survivors and the
//     parity where they lie, with no concatenation, and any row stride
//     works.  More rows than kMaxRows take a generic loop over a pointer
//     array in device memory;
//   * registers, with nothing between loads and XORs: K is a template
//     parameter (1..kMaxRows), each thread owns kCols 16-byte columns of
//     its block's span and issues all K*kCols loads (ld.global.nc, no L1
//     allocation) before the first XOR; the output leaves with streaming
//     stores.  A design that brings each row's span into shared memory by
//     1-d bulk asynchronous copies (TMA) under an mbarrier, XORs it there
//     and stores it by bulk copy was built beside this one and measured
//     1 us slower at the main path's shape (PERF.md), so it is not kept;
//   * rows that do not start on a 16-byte boundary, or N not a multiple of
//     4 lanes, take the same kernel with 4-byte lanes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;
constexpr int kThreads = 256;
constexpr int kCols = 2;                  // 16-byte columns a thread a pass
constexpr int kMaxBlocksPerSm = 2;

struct Args {
  const void* row[kMaxRows];     // rows 0..k-1 when k <= kMaxRows
  const void* const* rows_dev;   // all k rows, in device memory, k > kMaxRows
  void* out;
  int64_t n;                     // lanes (int4 or int32) a row
  int64_t span;                  // lanes a block
  int k;
};

template <typename V>
__device__ __forceinline__ V ld_stream(const V* p);

template <>
__device__ __forceinline__ int4 ld_stream(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

template <>
__device__ __forceinline__ int ld_stream(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void xor_into(int4& a, const int4& b) {
  a.x ^= b.x;
  a.y ^= b.y;
  a.z ^= b.z;
  a.w ^= b.w;
}

__device__ __forceinline__ void xor_into(int& a, int b) { a ^= b; }

// K rows from the parameter struct.  Each pass of the loop loads kCols
// columns of every row, all before the first XOR.
template <int K, typename V>
__global__ void __launch_bounds__(kThreads) xor_rows(const Args a) {
  const int64_t lo = (int64_t)blockIdx.x * a.span;
  const int64_t hi = lmin(lo + a.span, a.n);
  V* out = static_cast<V*>(a.out);
  for (int64_t j0 = lo + threadIdx.x; j0 < hi; j0 += kThreads * kCols) {
    V v[K][kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t j = j0 + (int64_t)c * kThreads;
      if (j < hi) {
#pragma unroll
        for (int r = 0; r < K; ++r)
          v[r][c] = ld_stream(static_cast<const V*>(a.row[r]) + j);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t j = j0 + (int64_t)c * kThreads;
      if (j < hi) {
        V acc = v[0][c];
#pragma unroll
        for (int r = 1; r < K; ++r) xor_into(acc, v[r][c]);
        __stcs(out + j, acc);
      }
    }
  }
}

// k > kMaxRows: the row pointers come from device memory and the rows are
// walked in a loop, 4 rows of kCols columns in flight.
template <typename V>
__global__ void __launch_bounds__(kThreads) xor_rows_many(const Args a) {
  const int64_t lo = (int64_t)blockIdx.x * a.span;
  const int64_t hi = lmin(lo + a.span, a.n);
  V* out = static_cast<V*>(a.out);
  for (int64_t j0 = lo + threadIdx.x; j0 < hi; j0 += kThreads * kCols) {
    const V* first = static_cast<const V*>(a.rows_dev[0]);
    V acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t j = j0 + (int64_t)c * kThreads;
      if (j < hi) acc[c] = ld_stream(first + j);
    }
#pragma unroll 4
    for (int r = 1; r < a.k; ++r) {
      const V* row = static_cast<const V*>(a.rows_dev[r]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int64_t j = j0 + (int64_t)c * kThreads;
        if (j < hi) xor_into(acc[c], ld_stream(row + j));
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t j = j0 + (int64_t)c * kThreads;
      if (j < hi) __stcs(out + j, acc[c]);
    }
  }
}

int sm_count() {
  static int sms = 0;  // read once, outside any CUDA graph capture
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms < 1)
      sms = 132;
  }
  return sms;
}

// One wave of equal spans: at most `per_sm` blocks on every SM, a
// multiple of the SM count once there is work for more than one block an
// SM, each block at least one pass of its threads.
void split(Args& a, int per_sm, int* blocks) {
  const int sms = sm_count();
  const int64_t want = (a.n + kThreads - 1) / kThreads;
  int64_t g = want < (int64_t)sms * per_sm ? want : (int64_t)sms * per_sm;
  if (g > sms) g -= g % sms;
  a.span = (a.n + g - 1) / g;
  *blocks = (int)g;
}

template <void (*Kernel)(const Args)>
int launch(Args a, cudaStream_t s) {
  static int per_sm = 0;  // read once, outside any CUDA graph capture
  if (per_sm == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      kThreads, 0) !=
            cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;
  }
  int blocks = 0;
  split(a, per_sm, &blocks);
  Kernel<<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_lanes(const Args& a, cudaStream_t s) {
  switch (a.k) {
#define XOR_CASE(K) \
  case K:           \
    return launch<xor_rows<K, V>>(a, s);
    XOR_CASE(1) XOR_CASE(2) XOR_CASE(3) XOR_CASE(4) XOR_CASE(5) XOR_CASE(6)
    XOR_CASE(7) XOR_CASE(8) XOR_CASE(9) XOR_CASE(10) XOR_CASE(11)
    XOR_CASE(12) XOR_CASE(13) XOR_CASE(14) XOR_CASE(15) XOR_CASE(16)
#undef XOR_CASE
    default:
      return launch<xor_rows_many<V>>(a, s);
  }
}

}  // namespace

// rows: k pointers (host array) to rows of n int32 each on the current
// device; rows_dev: the same k pointers in device memory, read only when
// k > 16 (may be null otherwise); out: n int32.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int xor_rows_launch(const void* const* rows, int k,
                               const void* const* rows_dev, void* out,
                               int64_t n, void* stream) {
  if (k < 1 || n < 1 || out == nullptr ||
      (k > kMaxRows && rows_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{};
  bool vec = n % 4 == 0 && (uintptr_t)out % 16 == 0;
  for (int r = 0; r < k; ++r) {
    if (rows[r] == nullptr) return (int)cudaErrorInvalidValue;
    vec = vec && (uintptr_t)rows[r] % 16 == 0;
    if (r < kMaxRows) a.row[r] = rows[r];
  }
  a.rows_dev = rows_dev;
  a.out = out;
  a.k = k;
  a.n = vec ? n / 4 : n;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_lanes<int4>(a, s) : launch_lanes<int>(a, s);
}
