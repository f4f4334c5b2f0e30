// Flash attention forward on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (reached through `flash_attention`):
// q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> o (B,H,Sq,D) in q's type, softmax
// attention with a running max, sum and accumulator in float32.  Query row
// i sits at position i + Sk - Sq (causal aligned bottom-right); a key is
// kept when it is not in the future (causal) and qpos - kpos < window
// (window > 0, with or without causal).  A masked key weighs exactly 0, so
// a row that keeps no key is 0.  Query head h reads key/value head
// h / (H / Hkv) by index, with no copy.  Every tensor is addressed through
// its batch, head and row strides (the last dimension is contiguous), so
// (B,S,H,D) activations are read and written in place through their
// transposed views.  Like the Pallas kernel, it takes float16, bfloat16
// and float32 and any head dim D, here from 1 to 512.
//
// Bound: operations.  Per (query, kept key) pair the kernel does 4*D
// flops and reads each input once, so at the prefill shapes of qwen3-4b
// (B=2, S=4096, H=32, D=128, causal: 2.75e11 flop a layer) the least time
// is 0.278 ms at 989 TFLOP/s bf16 or fp16 against 0.05 ms to move the
// bytes at 3.35 TB/s.  Only Hopper's warpgroup MMA (`wgmma`) reaches that
// rate.
//
// The TPU kernel's grid (B*H, Sq/bq, Sk/bk) runs in order on one core and
// carries the softmax state in VMEM across its third dimension.  Here one
// block owns one tile of query rows of one (b, h) and walks the KV tiles
// in a loop, with the softmax state in registers.  Only the tiles that
// some row of the block can see are visited (the causal and window bounds
// of the loop), which skips what the TPU kernel skips with `pl.when`.
// Three kernels, chosen by the wrapper's `variant(dtype, D)`; each is
// compiled for a few pipeline widths W and runs any D <= W, the columns
// past D read as zeros and never stored:
//
//   * float16 or bfloat16, D % 8 == 0, 64 <= D <= 256 (`flash_fwd_wgmma`,
//     W = 64, 128 or 256), the model path.  FlashAttention-3's shape: a
//     block of 3 warpgroups owns 128 query rows.  What each choice does
//     about the bound:
//       - a producer warpgroup (one thread) keeps K/V tiles in flight by
//         TMA into a 2-stage shared-memory ring under mbarriers, so no
//         load waits for a product and the computing warps spend no
//         instructions or registers on copies; its registers go to the
//         consumers (`setmaxnreg` 40 / 232);
//       - two consumer warpgroups of 64 rows each compute S = Q K^T with
//         `wgmma` m64nBKk16 from shared memory (Q and K both K-major,
//         128-byte swizzle, as TMA writes them, so no bank conflicts), and
//         O += P V with P from registers (the f32 S fragment, rounded to
//         pairs of q's type, is the A fragment of the next k16 step) and
//         V read through the descriptor's transpose bit: no V transpose is
//         ever written;
//       - KV tiles of 128 keys (64 at W=256, for registers and shared
//         memory: 160 KB at W=128, 192 KB at W=256, one block an SM);
//       - D below W (zamba2's 112, or 72, 96, 136 ...): the tensor maps
//         have an inner dimension of D, so the 64-column boxes read the
//         columns past D as TMA's out-of-bounds zeros (nothing is padded
//         or copied in device memory), and only the boxes that hold data
//         are loaded.  Q K^T takes the ceil(D/16) k16 steps that hold
//         data (at W = 256 whole panels of 4), the step count a template
//         parameter, so each count is a kernel of its own with no branch
//         in its pipeline; P V runs at N=W and its columns past D are not
//         stored;
//       - the per-element mask runs only on tiles that cross the causal
//         diagonal, the window edge or the end of the keys, as two
//         compares a logit against per-row bounds (each register's column
//         is a compile-time constant); TMA's out-of-bounds zero fill gives
//         the ragged last tile its zeros;
//       - exp2 with scale * log2(e) folded into one FMA a weight;
//       - the grid puts the query tile in its slow dimension, last tile
//         first, so the blocks with the most keys start in the first wave
//         and the tail holds the short ones.
//     The two consumers run independently, so one's softmax overlaps the
//     other's products.  FlashAttention-3's overlap inside a warpgroup
//     (the next tile's Q K^T issued before this tile's softmax) and a
//     ping-pong of the consumers on named barriers were measured slower or
//     no faster (ptxas spills the larger live set and serialises the
//     wgmma); PERF.md has the numbers.
//   * float16 or bfloat16, D % 8 == 0, D < 64 (`flash_fwd_mma`, W = 16, 32
//     or 64): mma.sync m16n8k16, 4 warps x 16 query rows, 64 keys a tile,
//     synchronous 16-byte tile loads that write zeros past D.
//   * float32 at any D, and float16 or bfloat16 where no tensor-core route
//     applies (D % 8 != 0, or D > 256) (`flash_fwd_simt`, W = 32 ... 512):
//     plain FMA in float32 from tiles converted to float32 in shared
//     memory, 4 warps x 4 query rows, 32 keys a tile (one per lane).
//     Shared memory (about 320 D bytes) sets the cap: D = 512 takes 164
//     KB of the 227 KB a block may have.  Right, but slow.
//
// 16-bit products are exact in float32, so Q K^T differs from the
// reference only in summation order; P is rounded to q's type for the P V
// product (the row sums use the unrounded P), a relative error of 2^-9 a
// weight in bfloat16 and 2^-11 in float16, inside the tolerances of 2e-2
// and 5e-3.  Blocks above 48 KB of shared memory are allowed once per
// instantiation with cudaFuncSetAttribute; the TMA descriptors are
// encoded on the host at every call and passed by value, so a captured
// CUDA graph keeps them.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kThreads = 128;      // 4 warps (simt and mma kernels)
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, Sq, Sk, D;
  int causal, window;
  float scale;
  // element strides of batch, head and row; the last dimension is dense
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
};

template <typename T>
constexpr bool kIsF16 = std::is_same_v<T, f16>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (kIsF16<T>) return __float2half_rn(x);
  else if constexpr (std::is_same_v<T, bf16>) return __float2bfloat16_rn(x);
  else return x;
}

// two floats -> a pair of T (f16 or bf16), `lo` in the low half (the
// lower column index)
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (kIsF16<T>) {
    __half2 t = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&t);
  } else {
    __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&t);
  }
}

__device__ __forceinline__ bool kept(const Params& p, int qpos, int kpos) {
  return kpos < p.Sk && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// First and one-past-last key position that query positions
// [q_first, q_last] can keep.
__device__ __forceinline__ void kv_range(const Params& p, int q_first,
                                         int q_last, int& kbeg, int& kend) {
  kbeg = 0;
  kend = p.Sk;
  if (p.causal) kend = min(kend, q_last + 1);
  if (p.window > 0) kbeg = max(0, q_first - p.window + 1);
}

// ------------------------------------------------------------ float32 FMA

namespace simt {
constexpr int kRows = 4;             // query rows per warp
constexpr int kBQ = 4 * kRows;       // query rows per block
constexpr int kBK = 32;              // keys per tile, one per lane
// floats of a shared-memory row of Q and V: D rounded up to whole float4
// reads (zeros past D); a K row has 4 more, so that the lanes' float4
// reads of their own rows spread over the banks
__host__ __device__ inline int row(int D) { return (D + 3) / 4 * 4; }
inline size_t smem_bytes(int D) {
  const int r = row(D);
  return sizeof(float) * (kBQ * r + kBK * (r + 4) + kBK * r);
}
}  // namespace simt

// T: the inputs' and output's type; W: a multiple of 32 >= D, the
// accumulator columns a lane holds (W / 32).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt(const Params p) {
  using namespace simt;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, R = row(D);
  float* Qs = smem;                  // [kBQ][R]
  float* Ks = Qs + kBQ * R;          // [kBK][R + 4]
  float* Vs = Ks + kBK * (R + 4);    // [kBK][R]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const T* q = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* k = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* v = (const T*)p.v + b * p.v_sb + hk * p.v_sh;
  T* o = (T*)p.o + b * p.o_sb + h * p.o_sh;

  const int q0 = blockIdx.x * kBQ;
  const int off = p.Sk - p.Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp * kRows;

  for (int i = tid; i < kBQ * R; i += kThreads) {
    const int r = i / R, c = i % R;
    Qs[i] = q0 + r < p.Sq && c < D ? to_f32(q[(q0 + r) * p.q_ss + c]) : 0.f;
  }

  int kbeg, kend;
  kv_range(p, q0 + off, min(q0 + kBQ, p.Sq) - 1 + off, kbeg, kend);

  constexpr int kCols = W / 32;  // output columns per lane
  float acc[kRows][kCols];
  float m[kRows], l[kRows];  // l: this lane's share of the row sum
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = (kbeg / kBK) * kBK; k0 < kend; k0 += kBK) {
    __syncthreads();  // Q is in; the previous tile is consumed
    for (int i = tid; i < kBK * R; i += kThreads) {
      const int r = i / R, c = i % R;
      const bool in = k0 + r < p.Sk && c < D;
      Ks[r * (R + 4) + c] = in ? to_f32(k[(k0 + r) * p.k_ss + c]) : 0.f;
      Vs[r * R + c] = in ? to_f32(v[(k0 + r) * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (R + 4);
#pragma unroll 4
    for (int d = 0; d < R; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (wr + r) * R + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
    float pr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = kept(p, q0 + wr + r + off, kpos);
      const float x = ok ? s[r] * p.scale : kNegInf;
      float mx = x;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, sh));
      const float mn = fmaxf(m[r], mx);
      const float e = ok ? expf(x - mn) : 0.f;
      const float alpha = expf(m[r] - mn);
      m[r] = mn;
      l[r] = l[r] * alpha + e;
      pr[r] = e;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pj[r] = __shfl_sync(kFull, pr[r], j);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float vv = Vs[j * R + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float tot = l[r];
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      tot += __shfl_xor_sync(kFull, tot, sh);
    const float denom = tot == 0.f ? 1.f : tot;
    const int row = q0 + wr + r;
    if (row < p.Sq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < D) o[row * p.o_ss + d] = from_f32<T>(acc[r][c] / denom);
      }
    }
  }
}

// --------------------------------- float16 / bfloat16 tensor cores, mma.sync

namespace tc {
constexpr int kBQ = 64;  // 4 warps x 16 query rows
constexpr int kBK = 64;  // keys per tile
template <int W>
__host__ __device__ constexpr int stride() {
  return W + 8;  // 16-bit elements per shared-memory row
}
template <int W>
constexpr size_t smem_bytes() {
  return 2 * (kBQ + 2 * kBK) * stride<W>();
}
}  // namespace tc

// c += a (16x16, row) * b (16x8, col) in T (f16 or bf16), float32
// accumulate.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
#define FLASH_MMA(TY)                                                      \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "  \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"   \
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])            \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1))
  if constexpr (kIsF16<T>) FLASH_MMA("f16");
  else FLASH_MMA("bf16");
#undef FLASH_MMA
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(const uint16_t* lo,
                                          const uint16_t* hi) {
  return uint32_t(*lo) | (uint32_t(*hi) << 16);
}

// rows x W 16-bit elements from global `src` (row r at src + r*ld; rows
// past `valid` and columns past D read as 0) into shared `dst` with the
// padded stride, 16 bytes a thread (D is a multiple of 8).
template <int W>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          int64_t ld, int rows, int valid,
                                          int D, int tid) {
  constexpr int kChunks = W / 8;
  for (int i = tid; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < D)
      val = *reinterpret_cast<const uint4*>(src + r * ld + c);
    *reinterpret_cast<uint4*>(dst + r * tc::stride<W>() + c) = val;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma(const Params p) {
  using namespace tc;
  constexpr int S = stride<W>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);  // [kBQ][S]
  uint16_t* Ks = Qs + kBQ * S;                            // [kBK][S]
  uint16_t* Vs = Ks + kBK * S;                            // [kBK][S]

  const int D = p.D;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const uint16_t* q = (const uint16_t*)p.q + b * p.q_sb + h * p.q_sh;
  const uint16_t* k = (const uint16_t*)p.k + b * p.k_sb + hk * p.k_sh;
  const uint16_t* v = (const uint16_t*)p.v + b * p.v_sb + hk * p.v_sh;
  uint16_t* o = (uint16_t*)p.o + b * p.o_sb + h * p.o_sh;

  const int q0 = blockIdx.x * kBQ;
  const int off = p.Sk - p.Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;  // this thread's rows
  const int qp0 = row0 + off, qp1 = row1 + off;

  load_tile<W>(Qs, q + q0 * p.q_ss, p.q_ss, kBQ, p.Sq - q0, D, tid);

  int kbeg, kend;
  kv_range(p, q0 + off, min(q0 + kBQ, p.Sq) - 1 + off, kbeg, kend);

  float acc[W / 8][4];
#pragma unroll
  for (int dt = 0; dt < W / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  for (int k0 = (kbeg / kBK) * kBK; k0 < kend; k0 += kBK) {
    __syncthreads();  // Q is in; the previous tile is consumed
    load_tile<W>(Ks, k + k0 * p.k_ss, p.k_ss, kBK, p.Sk - k0, D, tid);
    load_tile<W>(Vs, v + k0 * p.v_ss, p.v_ss, kBK, p.Sk - k0, D, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 tiles of 16x8, over
    // the k16 steps that hold data
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W; kk += 16) {
      if (kk < D) {
        const uint16_t* qa = Qs + (wr + g) * S + kk + 2 * t;
        const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * S);
        const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * S + 8);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint16_t* kb = Ks + (nt * 8 + g) * S + kk + 2 * t;
          mma16816<T>(s[nt], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
        }
      }
    }

    // scale and mask (masked -> -inf, so its weight is exactly 0), row max
    const float kMinusInf = __int_as_float(0xff800000);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + nt * 8 + 2 * t + e;
        s[nt][e] = kept(p, qp0, kpos) ? s[nt][e] * p.scale : kMinusInf;
        s[nt][2 + e] = kept(p, qp1, kpos) ? s[nt][2 + e] * p.scale : kMinusInf;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {  // the 4 threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = expf(s[nt][e] - mn0);
        s[nt][2 + e] = expf(s[nt][2 + e] - mn1);
        rs0 += s[nt][e];
        rs1 += s[nt][2 + e];
      }
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int dt = 0; dt < W / 8; ++dt) {
      acc[dt][0] *= al0;
      acc[dt][1] *= al0;
      acc[dt][2] *= al1;
      acc[dt][3] *= al1;
    }

    // O += P V: P (16 x 64, in T) from the S registers, V from shared; the
    // 8-column tiles past D are skipped
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a0 = pack<T>(s[2 * kc][0], s[2 * kc][1]);
      const uint32_t a1 = pack<T>(s[2 * kc][2], s[2 * kc][3]);
      const uint32_t a2 = pack<T>(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      const uint32_t a3 = pack<T>(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < W / 8; ++dt) {
        if (dt * 8 < D) {
          const uint16_t* vb = Vs + (kc * 16 + 2 * t) * S + dt * 8 + g;
          mma16816<T>(acc[dt], a0, a1, a2, a3, pack2(vb, vb + S),
                      pack2(vb + 8 * S, vb + 9 * S));
        }
      }
    }
  }

#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, sh);
    l1 += __shfl_xor_sync(kFull, l1, sh);
  }
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int dt = 0; dt < W / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (col >= D) continue;
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(o + row0 * p.o_ss + col) =
          pack<T>(acc[dt][0] / d0, acc[dt][1] / d0);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(o + row1 * p.o_ss + col) =
          pack<T>(acc[dt][2] / d1, acc[dt][3] / d1);
  }
}

// ------------------ float16 / bfloat16 tensor cores, TMA + wgmma (Hopper)

namespace wg {
constexpr int kBQ = 128;       // query rows a block: 2 consumers x 64
constexpr int kThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kStages = 2;     // K/V ring depth
constexpr int kPanelRow = 128; // bytes of one swizzled row: 64 elements
// keys a tile at pipeline width W (W a multiple of 64: whole panels)
template <int W>
__host__ __device__ constexpr int bk() {
  return W == 256 ? 64 : 128;
}
template <int W>
__host__ __device__ constexpr int q_bytes() {
  return kBQ * W * 2;
}
template <int W>
__host__ __device__ constexpr int kv_bytes() {
  return bk<W>() * W * 2;  // one K or V tile
}
template <int W>
constexpr size_t smem_bytes() {
  // 1024 bytes of slack to align the swizzled tiles, then Q, the K ring,
  // the V ring and 7 mbarriers
  return 1024 + q_bytes<W>() + 2 * kStages * kv_bytes<W>() + 64;
}
}  // namespace wg

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.  A
// wait that never ends is a fault of the pipeline: after 2^22 polls
// (seconds) the block traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 22)) __trap();
  }
}

// One 64-column panel of a tile: box (64, rows) of a 4-d tensor map
// (D, S, heads, B) at (col, row, head, b), into 128-byte swizzled rows.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands
// (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused.  MN-major (V read transposed): 8-key groups
// 1024 bytes apart (SBO), 64-column panels `lbo` bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins reads and writes of an accumulator after the wait that made it
// valid: the compiler sees each register as rewritten here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator operands of a wgmma: N/2 floats a thread ("+f"), and
// the matching placeholders %0 ... of the instruction's first operand.
#define FLASH_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FLASH_F16(i) FLASH_F4(i), FLASH_F4(i + 4), FLASH_F4(i + 8), \
                     FLASH_F4(i + 12)
#define FLASH_F32(i) FLASH_F16(i), FLASH_F16(i + 16)
#define FLASH_F64(i) FLASH_F32(i), FLASH_F32(i + 32)
#define FLASH_F128(i) FLASH_F64(i), FLASH_F64(i + 64)
#define FLASH_R32                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, "               \
  "%8, %9, %10, %11, %12, %13, %14, %15, "         \
  "%16, %17, %18, %19, %20, %21, %22, %23, "       \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define FLASH_R64                                  \
  FLASH_R32 ", "                                   \
  "%32, %33, %34, %35, %36, %37, %38, %39, "       \
  "%40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, "       \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define FLASH_R128                                 \
  FLASH_R64 ", "                                   \
  "%64, %65, %66, %67, %68, %69, %70, %71, "       \
  "%72, %73, %74, %75, %76, %77, %78, %79, "       \
  "%80, %81, %82, %83, %84, %85, %86, %87, "       \
  "%88, %89, %90, %91, %92, %93, %94, %95, "       \
  "%96, %97, %98, %99, %100, %101, %102, %103, "   \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"

// S (64 x N, f32) (+)= A (64 x 16) B (N x 16)^T in T (f16 or bf16), A and
// B in shared memory, both K-major; `accumulate` = 0 overwrites S.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
#define FLASH_WGMMA(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
               FLASH_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                 \
               : FLASH_F32(0)                                               \
               : "l"(a), "l"(b), "r"(accumulate))
  if constexpr (kIsF16<T>) FLASH_WGMMA("f16");
  else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
#define FLASH_WGMMA(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
               FLASH_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                  \
               : FLASH_F64(0)                                                \
               : "l"(a), "l"(b), "r"(accumulate))
  if constexpr (kIsF16<T>) FLASH_WGMMA("f16");
  else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

// O (64 x N, f32) += A (64 x 16 in T, registers) B (16 x N); B in shared
// memory with N contiguous (MN-major), read through the transpose bit.
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
#define FLASH_WGMMA(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
               FLASH_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"   \
               : FLASH_F32(0)                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
  if constexpr (kIsF16<T>) FLASH_WGMMA("f16");
  else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
#define FLASH_WGMMA(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
               FLASH_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"    \
               : FLASH_F64(0)                                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
  if constexpr (kIsF16<T>) FLASH_WGMMA("f16");
  else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
#define FLASH_WGMMA(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"   \
               FLASH_R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
               : FLASH_F128(0)                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
  if constexpr (kIsF16<T>) FLASH_WGMMA("f16");
  else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64<T>(d, a, b, accumulate);
  else wgmma_ss_n128<T>(d, a, b, accumulate);
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64<T>(d, a, b);
  else if constexpr (N == 128) wgmma_rs_n128<T>(d, a, b);
  else wgmma_rs_n256<T>(d, a, b);
}

// S = Q K^T over KS k16 steps: one whole wgmma pipeline stage (fence,
// products, commit, wait).
template <typename T, int BK, int KS>
__device__ __forceinline__ void qk_stage(float (&sc)[BK / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  constexpr int kQPanel = wg::kBQ * wg::kPanelRow;
  constexpr int kKPanel = BK * wg::kPanelRow;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t step = (kk & 3) * 32;  // 16 columns in the panel
    wgmma_ss<T, BK>(sc, smem_desc(q_addr + (kk >> 2) * kQPanel + step, 16),
                    smem_desc(k_addr + (kk >> 2) * kKPanel + step, 16),
                    kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
}

// T: f16 or bf16; W: the pipeline width (64, 128 or 256); KS: the k16
// steps of Q K^T, ceil(D/16) (at W = 256 rounded up to 12 or 16, whole
// panels); D, a multiple of 8, in (16 (KS - 1), 16 KS] at W <= 128 and in
// (W/2, W] at W = 256 (64 at W = 64).
template <typename T, int W, int KS>
__global__ void __launch_bounds__(wg::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using namespace wg;
  constexpr int BK = bk<W>();
  constexpr int kQPanel = kBQ * kPanelRow;  // bytes of a 64-column panel
  constexpr int kKPanel = BK * kPanelRow;
  constexpr int kPanels = (KS + 3) / 4;     // the boxes that hold data
  constexpr int kChunks = 2 * KS;           // 16-byte chunks of a row
  const int D = p.D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + q_bytes<W>();                // [stage]
  unsigned char* Vs = Ks + kStages * kv_bytes<W>();     // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * kv_bytes<W>());
  uint64_t* k_full = q_full + 1;                        // [stage]
  uint64_t* v_full = k_full + kStages;                  // [stage]
  uint64_t* empty = v_full + kStages;                   // [stage]

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // last tile first
  const int off = p.Sk - p.Sq;
  int kbeg, kend;
  kv_range(p, q0 + off, min(q0 + kBQ, p.Sq) - 1 + off, kbeg, kend);
  const int t_first = kbeg / BK;
  const int n_tiles = kend > kbeg ? (kend - 1) / BK + 1 - t_first : 0;

  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: one thread issues every load; a box counts its whole
    // size, columns past D included (TMA's zero fill)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect_tx(q_full, kPanels * kQPanel);
      for (int c = 0; c < kPanels; ++c)
        tma_load(Qs + c * kQPanel, &tq, q_full, 64 * c, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t use = it / kStages;
        mbar_wait(&empty[s], (use & 1) ^ 1);  // the first use passes
        const int k0 = (t_first + it) * BK;
        unsigned char* kd = Ks + s * kv_bytes<W>();
        unsigned char* vd = Vs + s * kv_bytes<W>();
        mbar_expect_tx(&k_full[s], kPanels * kKPanel);
        for (int c = 0; c < kPanels; ++c)
          tma_load(kd + c * kKPanel, &tk, &k_full[s], 64 * c, k0, hk, b);
        mbar_expect_tx(&v_full[s], kPanels * kKPanel);
        for (int c = 0; c < kPanels; ++c)
          tma_load(vd + c * kKPanel, &tv, &v_full[s], 64 * c, k0, hk, b);
      }
    }
  } else {
    // ---- consumer warpgroup cw: query rows q0 + 64 cw ... + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wgi - 1;
    const int g = lane >> 2, t = lane & 3;  // accumulator fragment coords
    const int r0 = 16 * warp + g;           // rows r0 and r0 + 8 of 64
    const int row0 = q0 + 64 * cw + r0;
    const int qp0 = row0 + off, qp1 = qp0 + 8;
    const int pos_lo = q0 + 64 * cw + off, pos_hi = pos_lo + 63;
    const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)
    const float kMinusInf = __int_as_float(0xff800000);
    const uint32_t q_addr = smem_u32(Qs) + cw * 64 * kPanelRow;

    float acc[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // running max of the raw logits
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the sums

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int k0 = (t_first + it) * BK;
      const uint32_t k_addr = smem_u32(Ks + s * kv_bytes<W>());
      const uint32_t v_addr = smem_u32(Vs + s * kv_bytes<W>());

      // S = Q K^T (64 x BK) from shared memory, over the k16 steps that
      // hold data
      float sc[BK / 2];
      mbar_wait(&k_full[s], parity);
      qk_stage<T, BK, KS>(sc, q_addr, k_addr);

      // the per-element mask, only where some key of the tile is masked
      // for some row of this warpgroup
      const bool edge = k0 + BK > p.Sk ||
                        (p.causal && k0 + BK - 1 > pos_lo) ||
                        (p.window > 0 && pos_hi - k0 >= p.window);
      if (edge) {
        // key k0 + 2t + c of row r is kept iff lo_r <= c <= hi_r, and the
        // column offset c of each register is a compile-time constant
        const int base = k0 + 2 * t;
        const int hi0 = min(p.Sk - 1, p.causal ? qp0 : 0x7fffffff) - base;
        const int hi1 = min(p.Sk - 1, p.causal ? qp1 : 0x7fffffff) - base;
        const int lo0 = p.window > 0 ? qp0 - p.window + 1 - base : -0x7fffffff;
        const int lo1 = p.window > 0 ? qp1 - p.window + 1 - base : -0x7fffffff;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int c = 8 * (i >> 2) + (i & 1);
          if (c > ((i & 2) ? hi1 : hi0) || c < ((i & 2) ? lo1 : lo0))
            sc[i] = kMinusInf;
        }
      }

      // online softmax in base 2: p = 2^(s * sl2 - m * sl2)
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, sc[i]);
        else mx0 = fmaxf(mx0, sc[i]);
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {  // the 4 threads of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, sh));
      }
      const float al0 = ex2((m0 - mx0) * sl2), al1 = ex2((m1 - mx1) * sl2);
      m0 = mx0;
      m1 = mx1;
      const float ms0 = mx0 * sl2, ms1 = mx1 * sl2;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (i & 2) {
          sc[i] = ex2(fmaf(sc[i], sl2, -ms1));
          rs1 += sc[i];
        } else {
          sc[i] = ex2(fmaf(sc[i], sl2, -ms0));
          rs0 += sc[i];
        }
      }
      l0 = l0 * al0 + rs0;
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;

      // P as the A fragments of the k16 steps of P V
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack<T>(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V, V read transposed from its [key][W] tile; the columns
      // past D (zeros, or panels never loaded) are not stored
      mbar_wait(&v_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<T, W>(acc, pa[kk], smem_desc(v_addr + kk * 16 * kPanelRow,
                                             kKPanel));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the stage may be refilled
    }

    // epilogue: normalise, stage the rows in this warpgroup's own Q rows
    // (same swizzle), then 16-byte coalesced stores through o's strides of
    // the first D columns
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      l0 += __shfl_xor_sync(kFull, l0, sh);
      l1 += __shfl_xor_sync(kFull, l1, sh);
    }
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    unsigned char* orow = Qs + cw * 64 * kPanelRow;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (8 * j >= D) continue;
      unsigned char* a = orow + (j >> 3) * kQPanel + r0 * kPanelRow +
                         (((j & 7) ^ (r0 & 7)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(a) =
          pack<T>(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(a + 8 * kPanelRow) =
          pack<T>(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    uint16_t* o = (uint16_t*)p.o + b * p.o_sb + h * p.o_sh;
    for (int c = tid; c < 64 * kChunks; c += 128) {
      const int r = c / kChunks, j = c % kChunks;
      const int row = q0 + 64 * cw + r;
      if (row < p.Sq && 8 * j < D) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            orow + (j >> 3) * kQPanel + r * kPanelRow +
            (((j & 7) ^ (r & 7)) << 4));
        *reinterpret_cast<uint4*>(o + row * p.o_ss + 8 * j) = val;
      }
    }
  }
}

// ----------------------------------------------------------------- launch

template <typename Kernel>
int set_smem(Kernel kernel, bool& attr_set, size_t smem) {
  if (attr_set) return 0;  // once per kernel, before any graph capture
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attr_set = true;
  return 0;
}

// a kernel of 128 threads on a grid (query tiles of `rows_per_block`,
// B*H); `max_smem` is its largest dynamic shared memory, `smem` this
// launch's
template <typename Kernel>
int run(Kernel kernel, bool& attr_set, size_t max_smem, size_t smem,
        int rows_per_block, const Params& p, cudaStream_t stream) {
  const int e = set_smem(kernel, attr_set, max_smem);
  if (e) return e;
  const dim3 grid((p.Sq + rows_per_block - 1) / rows_per_block, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, found in the libcuda the process has
// loaded (this library links no libcuda of its own).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A 16-bit tensor (B, heads, S, D) of type T with element strides sb, sh,
// ss as the 4-d map (D, S, heads, B); boxes of 64 columns x `rows`,
// 128-byte swizzle, columns past D and rows past S read as zeros.
template <typename T>
bool encode(CUtensorMap* map, const void* base, int D, int S, int heads,
            int B, int64_t sb, int64_t sh, int64_t ss, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map,
             kIsF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             4, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int W>
int launch_simt(const Params& p, cudaStream_t stream) {
  static bool attr = false;
  return run(flash_fwd_simt<T, W>, attr, simt::smem_bytes(W),
             simt::smem_bytes(p.D), simt::kBQ, p, stream);
}

template <typename T, int W>
int launch_mma(const Params& p, cudaStream_t stream) {
  static bool attr = false;
  return run(flash_fwd_mma<T, W>, attr, tc::smem_bytes<W>(),
             tc::smem_bytes<W>(), tc::kBQ, p, stream);
}

template <typename T, int W, int KS>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using namespace wg;
  static bool attr = false;
  const int e = set_smem(flash_fwd_wgmma<T, W, KS>, attr, smem_bytes<W>());
  if (e) return e;
  CUtensorMap tq, tk, tv;
  if (!encode<T>(&tq, p.q, p.D, p.Sq, p.H, p.B, p.q_sb, p.q_sh, p.q_ss,
                 kBQ) ||
      !encode<T>(&tk, p.k, p.D, p.Sk, p.Hkv, p.B, p.k_sb, p.k_sh, p.k_ss,
                 bk<W>()) ||
      !encode<T>(&tv, p.v, p.D, p.Sk, p.Hkv, p.B, p.v_sb, p.v_sh, p.v_ss,
                 bk<W>()))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd_wgmma<T, W, KS>
      <<<grid, wg::kThreads, smem_bytes<W>(), stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// The wgmma kernel for D in (W/2, W] (D = 64 at W = 64), by the k16 steps
// of its Q K^T: each step count is a kernel of its own, so no branch sits
// in the pipeline and each keeps the registers of one product chain (one
// kernel with a branch between step counts spilled 2.2 KB at W = 256 and
// ran D=112 3 % slower).  At W = 256 the steps come in whole panels, 12
// or 16, which keeps the build to 7 wgmma kernels a type.
template <typename T>
int launch_wgmma_d(const Params& p, int width, cudaStream_t st) {
  const int ks = (p.D + 15) / 16;
  if (width == 64 && p.D == 64) return launch_wgmma<T, 64, 4>(p, st);
  if (width == 128 && ks >= 5) {
    switch (ks) {
      case 5: return launch_wgmma<T, 128, 5>(p, st);
      case 6: return launch_wgmma<T, 128, 6>(p, st);
      case 7: return launch_wgmma<T, 128, 7>(p, st);
      case 8: return launch_wgmma<T, 128, 8>(p, st);
    }
  }
  if (width == 256 && ks >= 9) {
    if (ks <= 12) return launch_wgmma<T, 256, 12>(p, st);
    if (ks <= 16) return launch_wgmma<T, 256, 16>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// variant 0 = simt (W 32, 64, 128, 256, 512), 1 = mma (W 16, 32, 64; T
// 16-bit), 2 = wgmma (W 64, 128, 256; T 16-bit)
template <typename T>
int launch_t(const Params& p, int variant, int width, cudaStream_t st) {
  const int D = p.D;
  if (variant == 0) {
    switch (width) {
      case 32: return launch_simt<T, 32>(p, st);
      case 64: return launch_simt<T, 64>(p, st);
      case 128: return launch_simt<T, 128>(p, st);
      case 256: return launch_simt<T, 256>(p, st);
      case 512: return launch_simt<T, 512>(p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if constexpr (!std::is_same_v<T, float>) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    if (variant == 1) {
      switch (width) {
        case 16: return launch_mma<T, 16>(p, st);
        case 32: return launch_mma<T, 32>(p, st);
        case 64: return launch_mma<T, 64>(p, st);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    if (variant == 2) return launch_wgmma_d<T>(p, width, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,H,Sq,D), k and v (B,Hkv,Sk,D), o (B,H,Sq,D), each addressed by its
// element strides (batch, head, row; `strides` holds 12 of them in the
// order q, k, v, o) with a dense last dimension, on the current device.
// dtype 0 = float32, 1 = bfloat16, 2 = float16.  variant 0 = float32 FMA
// (any D; starts and strides aligned to the element), 1 = mma.sync (D < 64,
// D % 8 == 0), 2 = TMA + wgmma (64 <= D <= 256, D % 8 == 0); 1 and 2 take
// 16-bit types with 16-byte aligned starts and strides.  `width` is the
// compiled pipeline width that runs D (D <= width).  Launches on `stream`
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      const int64_t* strides, int causal,
                                      int window, float scale, int dtype,
                                      int variant, int width, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      window < 0 || D < 1 || D > width || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  if (variant < 2 && (int64_t)B * H > 65535) return (int)cudaErrorInvalidValue;
  const int64_t* s = strides;
  const Params p{q, k, v, o, B, H, Hkv, Sq, Sk, D, causal ? 1 : 0, window,
                 scale, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                 s[9], s[10], s[11]};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_t<float>(p, variant, width, st);
    case 1: return launch_t<bf16>(p, variant, width, st);
    case 2: return launch_t<f16>(p, variant, width, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
