// XOR parity of K integer rows on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel `_xor_kernel` of
// src/repro/kernels/parity.py (reached through `xor_parity` and
// `reconstruct`): K rows of N elements of one integer type E -> (N,)
// int32, out[j] = x[0][j] ^ ... ^ x[K-1][j] stored in int32 as the Pallas
// kernel stores it (E = int8 or int16 sign-extended, uint8 or uint16
// zero-extended, 32-bit by its bits, 64-bit by its low 32 bits), bit-exact,
// for any K >= 1 and N >= 1.  raid5 parity is this function over a stripe
// round's data units (int32 lanes); a lost unit is this function over the
// survivors and the parity.
//
// XOR does not depend on the width of an element, so the rows are XORed in
// 16-byte vectors whatever E is, and only the store differs: a vector of
// 16 / sizeof(E) elements leaves as as many int32, widened or narrowed one
// by one (64, 32, 16 or 8 bytes).
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
//   * registers, with nothing between loads and XORs: for 32-bit rows (the
//     raid5 path) K is a template parameter (1..kMaxRows), each thread owns
//     kCols 16-byte columns of its block's span and issues all K*kCols
//     loads (ld.global.nc, no L1 allocation) before the first XOR; the
//     output leaves with streaming stores.  Rows of the other types, which
//     no path of the repo XORs on the card, take the generic loop over the
//     rows (one kernel a type and lane kind, not one a K).  A design that brings each row's span into shared memory by
//     1-d bulk asynchronous copies (TMA) under an mbarrier, XORs it there
//     and stores it by bulk copy was built beside this one and measured
//     1 us slower at the main path's shape (PERF.md), so it is not kept;
//   * rows that do not start on a 16-byte boundary, or rows whose bytes are
//     not a multiple of 16, take the same kernel element by element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;
constexpr int kThreads = 256;
constexpr int kCols = 2;                  // 16-byte columns a thread a pass
constexpr int kGroup = 4;                 // rows in flight in xor_rows_many
constexpr int kMaxBlocksPerSm = 2;

struct Args {
  const void* row[kMaxRows];     // rows 0..k-1 when k <= kMaxRows
  const void* const* rows_dev;   // all k rows, in device memory, k > kMaxRows
  void* out;                     // int32
  int64_t n;                     // lanes (int4 or E) a row
  int64_t span;                  // lanes a block
  int k;
};

// the row element types (the launcher's codes 0-5)
typedef signed char i8;
typedef unsigned char u8;
typedef short i16;
typedef unsigned short u16;
typedef long long i64;

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

// element lanes of the other types, loaded as the int lanes are
#define XOR_LD(E, PTX, C, R)                                            \
  template <>                                                           \
  __device__ __forceinline__ E ld_stream(const E* p) {                  \
    R v;                                                                \
    asm("ld.global.nc.L1::no_allocate." PTX " %0, [%1];\n"              \
        : "=" C(v)                                                      \
        : "l"(p));                                                      \
    return (E)v;                                                        \
  }
XOR_LD(i8, "s8", "r", int)
XOR_LD(u8, "u8", "r", unsigned)
XOR_LD(i16, "s16", "h", short)
XOR_LD(u16, "u16", "h", unsigned short)
XOR_LD(i64, "s64", "l", long long)
#undef XOR_LD

template <typename E>
__device__ __forceinline__ void xor_into(E& a, E b) {
  a ^= b;
}

// Stores lane j of the XOR in int32: a 16-byte lane (V = int4) holds
// 16 / sizeof(E) elements, each widened or narrowed by C's conversion to
// int (sign- or zero-extension, or the low 32 bits); an element lane
// (V = E) one.  For E = int the lane leaves as it came.
template <typename E, typename V>
__device__ __forceinline__ void store(int* out, int64_t j, const V& acc) {
  if constexpr (sizeof(V) == sizeof(E)) {
    __stcs(out + j, (int)acc);
  } else if constexpr (sizeof(E) == 4) {
    __stcs(reinterpret_cast<int4*>(out) + j, acc);
  } else if constexpr (sizeof(E) == 8) {
    __stcs(reinterpret_cast<int2*>(out) + j, make_int2(acc.x, acc.z));
  } else {
    constexpr int kPer = 16 / sizeof(E);
    E e[kPer];
    memcpy(e, &acc, 16);
    int4* o = reinterpret_cast<int4*>(out) + j * (kPer / 4);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q)
      __stcs(o + q, make_int4(e[4 * q], e[4 * q + 1], e[4 * q + 2],
                              e[4 * q + 3]));
  }
}

// K rows of E from the parameter struct, in lanes V (int4 or E).  Each
// pass of the loop loads kCols columns of every row, all before the first
// XOR.
template <int K, typename V, typename E>
__global__ void __launch_bounds__(kThreads) xor_rows(const Args a) {
  const int64_t lo = (int64_t)blockIdx.x * a.span;
  const int64_t hi = lmin(lo + a.span, a.n);
  int* out = static_cast<int*>(a.out);
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
        store<E>(out, j, acc);
      }
    }
  }
}

// Rows r0 .. r0 + kGroup - 1 that are below k, at the thread's kCols
// columns from j0, XORed into acc: all their loads issued before the first
// XOR.  row(r) gives row r's pointer.
template <typename V, typename Row>
__device__ __forceinline__ void xor_group(V (&acc)[kCols], const Row& row,
                                          int r0, int k, int64_t j0,
                                          int64_t hi) {
  V v[kGroup][kCols];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const V* p = r0 + g < k ? static_cast<const V*>(row(r0 + g)) : nullptr;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t j = j0 + (int64_t)c * kThreads;
      v[g][c] = p != nullptr && j < hi ? ld_stream(p + j) : V{};
    }
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int c = 0; c < kCols; ++c) xor_into(acc[c], v[g][c]);
}

// Any k, in groups of kGroup rows (xor_group): up to kMaxRows from the
// parameter struct, in a loop unrolled so that each pointer is read from
// the parameter bank at a fixed offset; more from device memory.
template <typename V, typename E>
__global__ void __launch_bounds__(kThreads) xor_rows_many(const Args a) {
  const int64_t lo = (int64_t)blockIdx.x * a.span;
  const int64_t hi = lmin(lo + a.span, a.n);
  int* out = static_cast<int*>(a.out);
  for (int64_t j0 = lo + threadIdx.x; j0 < hi; j0 += kThreads * kCols) {
    V acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = V{};
    if (a.k <= kMaxRows) {
#pragma unroll
      for (int r0 = 0; r0 < kMaxRows; r0 += kGroup)
        if (r0 < a.k)
          xor_group(acc, [&](int r) { return a.row[r]; }, r0, a.k, j0, hi);
    } else {
      for (int r0 = 0; r0 < a.k; r0 += kGroup)
        xor_group(acc, [&](int r) { return a.rows_dev[r]; }, r0, a.k, j0,
                  hi);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t j = j0 + (int64_t)c * kThreads;
      if (j < hi) store<E>(out, j, acc[c]);
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

// 32-bit rows by a kernel unrolled for their K up to kMaxRows; the other
// types, and more rows, by the loop
template <typename V, typename E>
int launch_lanes(const Args& a, cudaStream_t s) {
  if constexpr (sizeof(E) != 4) {
    return launch<xor_rows_many<V, E>>(a, s);
  } else {
    switch (a.k) {
#define XOR_CASE(K) \
  case K:           \
    return launch<xor_rows<K, V, E>>(a, s);
      XOR_CASE(1) XOR_CASE(2) XOR_CASE(3) XOR_CASE(4) XOR_CASE(5)
      XOR_CASE(6) XOR_CASE(7) XOR_CASE(8) XOR_CASE(9) XOR_CASE(10)
      XOR_CASE(11) XOR_CASE(12) XOR_CASE(13) XOR_CASE(14) XOR_CASE(15)
      XOR_CASE(16)
#undef XOR_CASE
      default:
        return launch<xor_rows_many<V, E>>(a, s);
    }
  }
}

// 16-byte lanes when every row and the output start on 16 bytes and a row
// is a whole number of them, else element lanes.
template <typename E>
int launch_type(Args& a, const void* const* rows, cudaStream_t s) {
  bool vec = a.n * (int64_t)sizeof(E) % 16 == 0 && (uintptr_t)a.out % 16 == 0;
  for (int r = 0; r < a.k; ++r) vec = vec && (uintptr_t)rows[r] % 16 == 0;
  if (!vec) return launch_lanes<E, E>(a, s);
  a.n = a.n * (int64_t)sizeof(E) / 16;
  return launch_lanes<int4, E>(a, s);
}

}  // namespace

// rows: k pointers (host array) to rows of n elements each of type `elem`
// (0 = int8, 1 = uint8, 2 = int16, 3 = uint16, 4 = int32 or uint32, 5 =
// int64 or uint64) on the current device, each aligned to its element;
// rows_dev: the same k pointers in device memory, read only when k > 16
// (may be null otherwise); out: n int32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int xor_rows_launch(const void* const* rows, int k,
                               const void* const* rows_dev, void* out,
                               int64_t n, int elem, void* stream) {
  if (k < 1 || n < 1 || out == nullptr || (uintptr_t)out % 4 != 0 ||
      (k > kMaxRows && rows_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{};
  for (int r = 0; r < k; ++r) {
    if (rows[r] == nullptr) return (int)cudaErrorInvalidValue;
    if (r < kMaxRows) a.row[r] = rows[r];
  }
  a.rows_dev = rows_dev;
  a.out = out;
  a.k = k;
  a.n = n;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case 0: return launch_type<i8>(a, rows, s);
    case 1: return launch_type<u8>(a, rows, s);
    case 2: return launch_type<i16>(a, rows, s);
    case 3: return launch_type<u16>(a, rows, s);
    case 4: return launch_type<int>(a, rows, s);
    case 5: return launch_type<i64>(a, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
