// XOR parity of K int32 rows on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel `_xor_kernel` of
// src/repro/kernels/parity.py (reached through `xor_parity` and
// `reconstruct`): (K, N) int32 -> (N,) int32, out[j] = x[0][j] ^ ... ^
// x[K-1][j].  raid5 parity is this function over a stripe round's data
// units; a lost unit is this function over the survivors and the parity.
//
// Bound: memory.  The kernel reads K*N*4 bytes and writes N*4 bytes and
// does (K-1)*N integer XORs, far below one operation per byte, so the
// least time is (K+1)*N*4 bytes over 3.35 TB/s: about 1.6 us for K=4,
// N=262144 (one 1 MiB stripe unit per row).  At that size the copy of the
// units between host and card, not this kernel, is expected to dominate
// a parity call.
//
// Design: no tiles and no shared memory; each thread owns 16-byte
// columns and XORs the K rows of a column in registers, walking the
// columns with a grid-stride loop.  K is a runtime argument.  The
// 16-byte path needs every row to start on a 16-byte boundary (N % 4 ==
// 0 and aligned base pointers); anything else takes the 4-byte path.
// The loop bound masks the tail, so N needs no padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void xor_rows_vec4(const int4* __restrict__ x,
                              int4* __restrict__ out, int k, int64_t n4) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n4;
       j += stride) {
    int4 acc = __ldg(x + j);
#pragma unroll 4
    for (int r = 1; r < k; ++r) {
      const int4 v = __ldg(x + (int64_t)r * n4 + j);
      acc.x ^= v.x;
      acc.y ^= v.y;
      acc.z ^= v.z;
      acc.w ^= v.w;
    }
    out[j] = acc;
  }
}

__global__ void xor_rows_scalar(const int32_t* __restrict__ x,
                                int32_t* __restrict__ out, int k,
                                int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    int32_t acc = __ldg(x + j);
#pragma unroll 4
    for (int r = 1; r < k; ++r) acc ^= __ldg(x + (int64_t)r * n + j);
    out[j] = acc;
  }
}

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads per SM

}  // namespace

// x: K*N contiguous int32 rows on the current device; out: N int32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int xor_parity_launch(const void* x, void* out, int k, int64_t n,
                                 void* stream) {
  if (k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int64_t work = vec ? n / 4 : n;
  static int sms = 0;  // read once, outside any CUDA graph capture
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess || sms < 1)
      sms = 132;
  }
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  const int blocks = (int)(want < cap ? want : cap);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    xor_rows_vec4<<<blocks, kThreads, 0, s>>>(
        (const int4*)x, (int4*)out, k, work);
  } else {
    xor_rows_scalar<<<blocks, kThreads, 0, s>>>(
        (const int32_t*)x, (int32_t*)out, k, n);
  }
  return (int)cudaGetLastError();
}
