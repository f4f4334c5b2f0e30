// Device and host helpers shared by the flash-attention sources
// (flash_attention.cu: the simt, mma and 16-bit wgmma kernels;
// flash_tf32.cu: the tf32 wgmma kernel), each built into a library of its
// own: the parameters, the type codes and float8 coding, masks, copies,
// mbarriers, TMA, wgmma descriptors and the tensor-map encoder.
#pragma once

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
  // element strides of batch, head, row and column (a dimension of size 1
  // may have any)
  int64_t q_sb, q_sh, q_ss, q_sd, k_sb, k_sh, k_ss, k_sd, v_sb, v_sh, v_ss,
      v_sd, o_sb, o_sh, o_ss, o_sd;
  // elements a copy of the mma and simt kernels moves: 16, 8, 4 or 2 (16
  // bytes' worth at most, the column stride 1, start, strides and D
  // multiples of it), or 1 (element by element, any strides)
  int q_vec, k_vec, v_vec, o_vec;
  // the type codes of q, k, v and o: 0 float32, 1 bfloat16, 2 float16, 3
  // float8_e4m3fn, 4 float8_e5m2, 5 float8_e4m3fnuz, 6 float8_e5m2fnuz, 7
  // float8_e8m0fnu
  int q_type, k_type, v_type, o_type;
};

template <typename T>
constexpr bool kIsF16 = std::is_same_v<T, f16>;

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

// ------------------------------------------------------- float8 and codes

__host__ __device__ inline int code_bytes(int code) {
  return code == 0 ? 4 : code < 3 ? 2 : 1;
}

// 2^k for k in [-126, 127], from its bits (exact)
__device__ __forceinline__ float pow2(int k) {
  return __uint_as_float((uint32_t)(k + 127) << 23);
}

// float32 -> the float8 type `code` (3-7), as the reference's `astype`
// rounds (XLA and ml_dtypes): to nearest, ties to even, at the format's
// spacing at |x|, with its own overflow, NaN and zero.  e4m3fn: no
// infinity, overflow and NaN give 0x7f | sign; e5m2: overflow gives
// infinity; the fnuz formats: one NaN code 0x80 (overflow too) and no
// negative zero.  e8m0fnu (exponent only, no sign, no zero): NaN 0xff for
// x <= 0, infinities and NaN, else the exponent of x plus one when bit 22
// of its mantissa is set and x is not a tie at 2^-127.
__device__ __forceinline__ uint8_t encode_f8(float x, int code) {
  const uint32_t b = __float_as_uint(x);
  if (code == 7) {
    const uint32_t e = b >> 23;
    if (!(x > 0.f) || e == 255) return 0xff;
    return (uint8_t)(e + ((b & 0x400000) && ((b & 0x3fffff) || e > 0)));
  }
  const uint32_t sign = (b >> 24) & 0x80;
  const bool fnuz = code >= 5;
  const int mb = code == 3 || code == 5 ? 3 : 2;
  const int bias = code == 3 ? 7 : code == 4 ? 15 : code == 5 ? 8 : 16;
  const float top = code == 3 ? 448.f : code == 5 ? 240.f : 57344.f;
  const uint8_t nan = fnuz ? 0x80 : (uint8_t)(sign | (mb == 3 ? 0x7f : 0x7e));
  if (isnan(x)) return nan;
  const int emin = 1 - bias;  // the least normal exponent
  const int e = max((int)((b >> 23) & 0xff) - 127, emin);
  // |x| at the spacing 2^(e - mb), rounded: exact scalings by powers of two
  const float y = rintf(fabsf(x) * pow2(mb - e)) * pow2(e - mb);
  if (y > top) return code == 4 ? (uint8_t)(sign | 0x7c) : nan;
  uint32_t mag = 0;
  if (y != 0.f) {
    const uint32_t yb = __float_as_uint(y);
    const int ye = (int)(yb >> 23) - 127;
    mag = ye >= emin ? ((uint32_t)(ye + bias) << mb) |
                           ((yb >> (23 - mb)) & ((1u << mb) - 1))
                     : (uint32_t)(y * pow2(mb - emin));
  }
  return fnuz && mag == 0 ? 0 : (uint8_t)(sign | mag);
}

// Two float32 outputs encoded as the float8 type CODE, the first in the
// low byte.  e4m3fn and e5m2 by the hardware's conversion (round to
// nearest even, as `encode_f8`), whose `satfinite` keeps the largest
// finite value where the reference overflows: past it, at the rounding
// midpoint to the next power of two (464 for e4m3fn, 61440 for e5m2, a
// tie there rounding up), e4m3fn gives NaN (0x7f | sign) and e5m2
// infinity (0x7c | sign), as `encode_f8` does.  The others by
// `encode_f8`, its constants folded.
template <int CODE>
__device__ __forceinline__ uint16_t encode_f8x2(float lo, float hi) {
  if constexpr (CODE == 3 || CODE == 4) {
    uint16_t r;
    if constexpr (CODE == 3)
      asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;\n"
          : "=h"(r) : "f"(hi), "f"(lo));
    else
      asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;\n"
          : "=h"(r) : "f"(hi), "f"(lo));
    const float big = CODE == 3 ? 464.f : 61440.f;
    const uint16_t over = CODE == 3 ? 0x7f : 0x7c;
    const bool olo = CODE == 3 ? fabsf(lo) > big : fabsf(lo) >= big;
    const bool ohi = CODE == 3 ? fabsf(hi) > big : fabsf(hi) >= big;
    if (olo) r = (r & 0xff00) | over | ((__float_as_uint(lo) >> 24) & 0x80);
    if (ohi)
      r = (r & 0x00ff) | ((over | ((__float_as_uint(hi) >> 24) & 0x80)) << 8);
    return r;
  } else {
    return (uint16_t)(encode_f8(lo, CODE) | (encode_f8(hi, CODE) << 8));
  }
}

// Four float8 bytes of type CODE (3-7) decoded into four float32 values,
// byte i into f[i], exactly and with no table: e4m3fn and e5m2 by the
// hardware's conversion to f16x2, then to float32; the fnuz formats from
// their bits as a float32 scaled by a power of two (a float8 subnormal is
// a float32 subnormal there, and the product is not flushed), NaN for
// their one NaN code 0x80; e8m0fnu 2^(b - 127) from its bits (byte 0 the
// float32 subnormal 2^-127, 0xff NaN).
template <int CODE>
__device__ __forceinline__ void dec4_f32(uint32_t x, float (&f)[4]) {
  if constexpr (CODE == 3 || CODE == 4) {
    uint32_t a, b;
    if constexpr (CODE == 3)
      asm("{\n.reg .b16 l, h;\nmov.b32 {l, h}, %2;\n"
          "cvt.rn.f16x2.e4m3x2 %0, l;\ncvt.rn.f16x2.e4m3x2 %1, h;\n}\n"
          : "=r"(a), "=r"(b)
          : "r"(x));
    else
      asm("{\n.reg .b16 l, h;\nmov.b32 {l, h}, %2;\n"
          "cvt.rn.f16x2.e5m2x2 %0, l;\ncvt.rn.f16x2.e5m2x2 %1, h;\n}\n"
          : "=r"(a), "=r"(b)
          : "r"(x));
    const float2 fa = __half22float2(*reinterpret_cast<const __half2*>(&a));
    const float2 fb = __half22float2(*reinterpret_cast<const __half2*>(&b));
    f[0] = fa.x;
    f[1] = fa.y;
    f[2] = fb.x;
    f[3] = fb.y;
  } else if constexpr (CODE == 5 || CODE == 6) {
    constexpr int mb = CODE == 5 ? 3 : 2, bias = CODE == 5 ? 8 : 16;
    // 2^(127 - bias): the float32 read of the magnitude bits is the value
    // over it
    const float scale = __uint_as_float((uint32_t)(254 - bias) << 23);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t byte = (x >> (8 * i)) & 0xff;
      const float m = __fmul_rn(__uint_as_float((byte & 0x7f) << (23 - mb)),
                                scale);
      f[i] = byte == 0x80 ? __uint_as_float(0x7fc00000u)
                          : (byte & 0x80 ? -m : m);
    }
  } else {
    static_assert(CODE == 7, "a float8 type code");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t byte = (x >> (8 * i)) & 0xff;
      f[i] = __uint_as_float(byte == 0 ? 0x00400000u
                             : byte == 0xff ? 0x7fc00000u : byte << 23);
    }
  }
}

// Four float8 bytes of type CODE (3-7) decoded into four values of the
// compute type T (f16 or bf16) for the tensor cores: bytes 0 and 1 as the
// pair `lo`, 2 and 3 as `hi`, the lower byte in the lower half.  Exact:
// every value of these formats is one of bfloat16's, and of float16's but
// for e8m0fnu (the route never pairs the two).  No table: e4m3fn and e5m2
// by the hardware's conversion to f16x2 (then f16 -> f32 -> bf16 for a
// bfloat16 T, each step exact: four instructions a pair; a bit-arithmetic
// decode of nine measured slower); the fnuz formats from their bits as a
// float32 scaled by a power of two (a float8 subnormal is a float32
// subnormal there, and the product is not flushed), NaN for their one NaN
// code 0x80; e8m0fnu
// (2^(b - 127), 0xff NaN) as bfloat16 bits, byte 0 a bfloat16 subnormal.
template <typename T, int CODE>
__device__ __forceinline__ void dec4(uint32_t x, uint32_t& lo, uint32_t& hi) {
  if constexpr (CODE == 3 || CODE == 4) {
    uint32_t a, b;
    if constexpr (CODE == 3)
      asm("{\n.reg .b16 l, h;\nmov.b32 {l, h}, %2;\n"
          "cvt.rn.f16x2.e4m3x2 %0, l;\ncvt.rn.f16x2.e4m3x2 %1, h;\n}\n"
          : "=r"(a), "=r"(b)
          : "r"(x));
    else
      asm("{\n.reg .b16 l, h;\nmov.b32 {l, h}, %2;\n"
          "cvt.rn.f16x2.e5m2x2 %0, l;\ncvt.rn.f16x2.e5m2x2 %1, h;\n}\n"
          : "=r"(a), "=r"(b)
          : "r"(x));
    if constexpr (kIsF16<T>) {
      lo = a;
      hi = b;
    } else {
      const float2 fa = __half22float2(*reinterpret_cast<const __half2*>(&a));
      const float2 fb = __half22float2(*reinterpret_cast<const __half2*>(&b));
      lo = pack<T>(fa.x, fa.y);
      hi = pack<T>(fb.x, fb.y);
    }
  } else if constexpr (CODE == 5 || CODE == 6) {
    float f[4];
    dec4_f32<CODE>(x, f);
    lo = pack<T>(f[0], f[1]);
    hi = pack<T>(f[2], f[3]);
  } else {
    static_assert(CODE == 7 && !kIsF16<T>, "e8m0fnu decodes to bf16 only");
    uint32_t h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t byte = (x >> (8 * i)) & 0xff;
      h[i] = byte == 0 ? 0x0040u : byte == 0xff ? 0x7fc0u : byte << 7;
    }
    lo = h[0] | (h[1] << 16);
    hi = h[2] | (h[3] << 16);
  }
}

// Calls f(std::integral_constant<int, CODE>) for the float8 type code
// `code` that compute type T takes (a branch uniform over the block), so
// each decoding loop is compiled once a format.
template <typename T, typename F>
__device__ __forceinline__ void with_code(int code, F&& f) {
  switch (code) {
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    default:
      if constexpr (!kIsF16<T>) f(std::integral_constant<int, 7>{});
  }
}

// Calls f(std::integral_constant<int, CODE>) for any type code 0-7 (a
// branch uniform over the block), so a loop over one tensor's elements is
// compiled once a type and holds no test of it.
template <typename F>
__device__ __forceinline__ void with_any_code(int code, F&& f) {
  switch (code) {
    case 0: f(std::integral_constant<int, 0>{}); break;
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    default: f(std::integral_constant<int, 7>{});
  }
}

// Bytes an element of type CODE takes.
template <int CODE>
constexpr int kBytes = CODE == 0 ? 4 : CODE < 3 ? 2 : 1;

// One element of type CODE (its bits in the low bytes of `x`) as float32,
// exactly.
template <int CODE>
__device__ __forceinline__ float dec1(uint32_t x) {
  if constexpr (CODE == 0) {
    return __uint_as_float(x);
  } else if constexpr (CODE == 1) {
    return __uint_as_float(x << 16);
  } else if constexpr (CODE == 2) {
    return __half2float(__ushort_as_half((unsigned short)x));
  } else {
    float f[4];
    dec4_f32<CODE>(x & 0xff, f);
    return f[0];
  }
}

// The 4 / kBytes<CODE> elements of type CODE (1-7) in the word `x` as
// float32, the lowest bytes first.
template <int CODE>
__device__ __forceinline__ void dec_word(uint32_t x, float* f) {
  if constexpr (CODE == 1) {
    f[0] = __uint_as_float(x << 16);
    f[1] = __uint_as_float(x & 0xffff0000u);
  } else if constexpr (CODE == 2) {
    const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&x));
    f[0] = h.x;
    f[1] = h.y;
  } else {
    float g[4];
    dec4_f32<CODE>(x, g);
    f[0] = g[0];
    f[1] = g[1];
    f[2] = g[2];
    f[3] = g[3];
  }
}

// A copy of N bytes (4, 8 or 16, N-aligned) at `x`, shared or device
// memory, in the low words of a uint4.
template <int N>
__device__ __forceinline__ uint4 load_copy(const void* x) {
  if constexpr (N == 16) {
    return *reinterpret_cast<const uint4*>(x);
  } else if constexpr (N == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(x);
    return make_uint4(u.x, u.y, 0, 0);
  } else {
    return make_uint4(*reinterpret_cast<const uint32_t*>(x), 0, 0, 0);
  }
}

// The N bytes of type CODE (1-7) in `w` (`load_copy`'s) decoded into
// N / kBytes<CODE> float32 at `d` (16-byte aligned but for 2 floats), in
// 16-byte stores (8 bytes for two floats); zeros where !ok.
template <int CODE, int N>
__device__ __forceinline__ void store_decoded(float* d, uint4 w, bool ok) {
  constexpr int EB = kBytes<CODE>, COUNT = N / EB;
  float f[16];
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < N / 4; ++i) dec_word<CODE>(words[i], f + i * (4 / EB));
  if constexpr (COUNT == 2) {
    *reinterpret_cast<float2*>(d) =
        ok ? make_float2(f[0], f[1]) : make_float2(0.f, 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < COUNT / 4; ++i)
      reinterpret_cast<float4*>(d)[i] =
          ok ? make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3])
             : make_float4(0.f, 0.f, 0.f, 0.f);
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

// ------------------------------------------------------- copies and fragments

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes (4, 8 or 16) from global `src` to shared `dst`, asynchronously;
// zeros when !ok (then nothing is read).
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(ok ? N : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// four 8x8 16-bit matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register i receives matrix i (`.trans`:
// transposed)
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

template <typename Kernel>
int set_smem(Kernel kernel, bool& attr_set, size_t smem) {
  if (attr_set) return 0;  // once per kernel, before any graph capture
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attr_set = true;
  return 0;
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

// A tensor (B, heads, S, D) of type `code` (1 bfloat16, 2 float16, 3-7
// float8) with element strides sb, sh, ss as the 4-d map (D, S, heads, B);
// boxes of 64 columns x `rows`, columns past D and rows past S read as
// zeros.  By default a 16-bit tensor lands in the 128-byte swizzle the
// wgmma descriptors read and a float8 one as raw bytes (UINT8, no
// swizzle: 64 bytes a row), which a producer decodes; `swizzle` names
// another.  A dimension of size 1 (stride 0 here) gets the stride of a
// dense layout.
bool encode(CUtensorMap* map, const void* base, int code, int D, int S,
            int heads, int B, int64_t sb, int64_t sh, int64_t ss, int rows,
            int swizzle = -1) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const int eb = code_bytes(code);
  if (S == 1) ss = D;
  if (heads == 1) sh = ss * S;
  if (B == 1) sb = sh * heads;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(ss * eb), (cuuint64_t)(sh * eb),
                                 (cuuint64_t)(sb * eb)};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      swizzle >= 0 ? (CUtensorMapSwizzle)swizzle
      : eb == 2    ? CU_TENSOR_MAP_SWIZZLE_128B
                   : CU_TENSOR_MAP_SWIZZLE_NONE;
  return enc(map,
             code == 1   ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
             : code == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             4, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The compute type of the tensor cores for q, k and v of type codes
// `types` (the wrapper's `compute_type`): 2 (float16) where some is
// float16 and each other float16 or a float8 format but e8m0fnu; 1
// (bfloat16) where none is float16 or float32; 3 (tf32) where some is
// float16 beside bfloat16 or e8m0fnu and none is float32 (every value of
// those types is one of tf32's); -1 (none) where some is float32.
constexpr int kTf32 = 3;
int compute_code(const int* types) {
  bool f16 = false, bf16 = false, e8m0 = false;
  for (int i = 0; i < 3; ++i) {
    if (types[i] == 0) return -1;
    f16 = f16 || types[i] == 2;
    bf16 = bf16 || types[i] == 1;
    e8m0 = e8m0 || types[i] == 7;
  }
  if (f16) return bf16 || e8m0 ? kTf32 : 2;
  return 1;
}

}  // namespace
