// Flash attention forward on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (reached through `flash_attention`):
// q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> o (B,H,Sq,D) in q's type, softmax
// attention with a running max, sum and accumulator in float32.  Query row
// i sits at position i + Sk - Sq (causal aligned bottom-right); a key is
// kept when it is not in the future (causal) and qpos - kpos < window
// (window > 0, with or without causal).  A row that keeps no key is 0.
// Query head h reads key/value head h / (H / Hkv) by index, with no copy.
//
// Bound: operations.  Per (query, kept key) pair the kernel does 4*D
// flops and reads each input once, so at the prefill shapes of qwen3-4b
// (B=2, S=4096, H=32, D=128, causal: 2.75e11 flop a layer) the least time
// is 0.28 ms at 989 TFLOP/s bf16 against 0.05 ms to move the bytes at
// 3.35 TB/s.
//
// Design.  The TPU kernel's grid (B*H, Sq/bq, Sk/bk) runs in order on one
// core and carries the softmax state in VMEM across its third dimension.
// Here one block owns (b*H + h, one tile of query rows) and walks the KV
// tiles in a loop, staging each K/V tile in shared memory; the softmax
// state stays in registers.  Only the tiles that some row of the block
// can see are visited (the causal and window bounds of the loop), which
// skips what the TPU kernel skips with `pl.when`.  Two kernels:
//
//   * float32 (`flash_fwd_simt`): plain FMA in float32, 4 warps x 4 query
//     rows, 32 keys a tile (one per lane).
//   * bfloat16 (`flash_fwd_mma`): tensor cores through mma.sync m16n8k16
//     with float32 accumulation, 4 warps x 16 query rows, 64 keys a tile
//     (the FlashAttention-2 layout: S = Q K^T stays in registers and is
//     fed back as the A operand of P V).  bf16 products are exact in
//     float32, so Q K^T differs from the reference only in summation
//     order; P is rounded to bf16 for the P V product (the row sums use
//     the unrounded P), which costs a relative error of about 2^-9 per
//     weight, inside the bf16 tolerance of 2e-2.
//
// Shared-memory rows are padded (4 floats, 8 bf16) so that the column
// reads of a warp fall in different banks.  Blocks above 48 KB of shared
// memory are allowed once per instantiation with cudaFuncSetAttribute.
// Both kernels load tiles synchronously (no cp.async, TMA or wgmma):
// making them fast is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kThreads = 128;      // 4 warps
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, Sq, Sk;
  int causal, window;
  float scale;
};

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
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 4) + kBK * D);
}
}  // namespace simt

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt(const Params p) {
  using namespace simt;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [kBQ][D]
  float* Ks = Qs + kBQ * D;          // [kBK][D + 4]
  float* Vs = Ks + kBK * (D + 4);    // [kBK][D]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const float* q = (const float*)p.q + (int64_t)bh * p.Sq * D;
  const float* k = (const float*)p.k + (int64_t)(b * p.Hkv + hk) * p.Sk * D;
  const float* v = (const float*)p.v + (int64_t)(b * p.Hkv + hk) * p.Sk * D;
  float* o = (float*)p.o + (int64_t)bh * p.Sq * D;

  const int q0 = blockIdx.x * kBQ;
  const int off = p.Sk - p.Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp * kRows;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[i] = q0 + r < p.Sq ? q[(int64_t)(q0 + r) * D + c] : 0.f;
  }

  int kbeg, kend;
  kv_range(p, q0 + off, min(q0 + kBQ, p.Sq) - 1 + off, kbeg, kend);

  constexpr int kCols = (D + 31) / 32;  // output columns per lane
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
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.Sk;
      const int64_t g = (int64_t)(k0 + r) * D + c;
      Ks[r * (D + 4) + c] = in ? k[g] : 0.f;
      Vs[r * D + c] = in ? v[g] : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (D + 4);
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (wr + r) * D + d);
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
          const float vv = Vs[j * D + d];
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
        if (d < D) o[(int64_t)row * D + d] = acc[r][c] / denom;
      }
    }
  }
}

// ------------------------------------------------- bfloat16 tensor cores

namespace tc {
constexpr int kBQ = 64;  // 4 warps x 16 query rows
constexpr int kBK = 64;  // keys per tile
template <int D>
__host__ __device__ constexpr int stride() {
  return D + 8;  // bf16 elements per shared-memory row
}
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (kBQ + 2 * kBK) * stride<D>();
}
}  // namespace tc

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

// rows x D bf16 from global `src` (row r at src + r*D; rows past `valid`
// read as 0) into shared `dst` with the padded stride, 16 bytes a thread.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows, int valid, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (int64_t)r * D + c);
    *reinterpret_cast<uint4*>(dst + r * tc::stride<D>() + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma(const Params p) {
  using namespace tc;
  constexpr int S = stride<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][S]
  bf16* Ks = Qs + kBQ * S;                        // [kBK][S]
  bf16* Vs = Ks + kBK * S;                        // [kBK][S]

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const bf16* q = (const bf16*)p.q + (int64_t)bh * p.Sq * D;
  const bf16* k = (const bf16*)p.k + (int64_t)(b * p.Hkv + hk) * p.Sk * D;
  const bf16* v = (const bf16*)p.v + (int64_t)(b * p.Hkv + hk) * p.Sk * D;
  bf16* o = (bf16*)p.o + (int64_t)bh * p.Sq * D;

  const int q0 = blockIdx.x * kBQ;
  const int off = p.Sk - p.Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;  // this thread's rows
  const int qp0 = row0 + off, qp1 = row1 + off;

  load_tile<D>(Qs, q + (int64_t)q0 * D, kBQ, p.Sq - q0, tid);

  int kbeg, kend;
  kv_range(p, q0 + off, min(q0 + kBQ, p.Sq) - 1 + off, kbeg, kend);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  for (int k0 = (kbeg / kBK) * kBK; k0 < kend; k0 += kBK) {
    __syncthreads();  // Q is in; the previous tile is consumed
    load_tile<D>(Ks, k + (int64_t)k0 * D, kBK, p.Sk - k0, tid);
    load_tile<D>(Vs, v + (int64_t)k0 * D, kBK, p.Sk - k0, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 tiles of 16x8
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const bf16* qa = Qs + (wr + g) * S + kk + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * S);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * S + 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kb = Ks + (nt * 8 + g) * S + kk + 2 * t;
        mma16816(s[nt], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
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
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= al0;
      acc[dt][1] *= al0;
      acc[dt][2] *= al1;
      acc[dt][3] *= al1;
    }

    // O += P V: P (16 x 64, bf16) from the S registers, V from shared
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* vb = Vs + (kc * 16 + 2 * t) * S + dt * 8 + g;
        mma16816(acc[dt], a0, a1, a2, a3, pack2(vb, vb + S),
                 pack2(vb + 8 * S, vb + 9 * S));
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
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(o + (int64_t)row0 * D + col) =
          pack_bf16(acc[dt][0] / d0, acc[dt][1] / d0);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(o + (int64_t)row1 * D + col) =
          pack_bf16(acc[dt][2] / d1, acc[dt][3] / d1);
  }
}

// ----------------------------------------------------------------- launch

template <typename Kernel>
int run(Kernel kernel, bool& attr_set, size_t smem, int rows_per_block,
        const Params& p, cudaStream_t stream) {
  if (!attr_set) {  // once per kernel, before any graph capture needs it
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((p.Sq + rows_per_block - 1) / rows_per_block, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    static bool attr = false;
    return run(flash_fwd_simt<D>, attr, simt::smem_bytes<D>(),
               simt::kBQ, p, stream);
  }
  static bool attr = false;
  return run(flash_fwd_mma<D>, attr, tc::smem_bytes<D>(), tc::kBQ, p, stream);
}

}  // namespace

// q (B,H,Sq,D), k and v (B,Hkv,Sk,D), o (B,H,Sq,D): contiguous, 16-byte
// aligned, on the current device; dtype 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      (int64_t)B * H > 65535 || window < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, H, Hkv, Sq, Sk, causal ? 1 : 0, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_d<16>(p, dtype, s);
    case 32: return launch_d<32>(p, dtype, s);
    case 64: return launch_d<64>(p, dtype, s);
    case 128: return launch_d<128>(p, dtype, s);
    case 256: return launch_d<256>(p, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
