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
// its batch, head, row and column strides, so (B,S,H,D) activations,
// strided and misaligned views are read and written in place.  Like the
// Pallas kernel, it takes any floating type for each of q, k and v (the
// Pallas kernel casts each to float32 and rounds the output to q's type):
// float32, bfloat16, float16 and the float8 formats e4m3fn, e5m2,
// e4m3fnuz, e5m2fnuz and e8m0fnu, any head dim D and any B*H (b*H + h is
// the grid's x everywhere).
//
// Bound: at D >= 64 in a 16-bit type, operations.  Per (query, kept key)
// pair the kernel does 4*D flops and one exp2 and reads each input once,
// so at the prefill shapes of qwen3-4b (B=2, S=4096, H=32, D=128, causal:
// 2.75e11 flop a layer) the least time is 0.278 ms at 989 TFLOP/s bf16 or
// fp16 against 0.128 ms for the 5.4e8 exp2 (16 a clock an SM) and 0.05 ms
// to move the bytes at 3.35 TB/s; below D = 64 the exp2 set it.  Only
// Hopper's warpgroup MMA (`wgmma`) reaches the tensor rate.  In float32
// the bound is the FMA rate (67 TFLOP/s): 4.1 ms there.
//
// The TPU kernel's grid (B*H, Sq/bq, Sk/bk) runs in order on one core and
// carries the softmax state in VMEM across its third dimension.  Here one
// block owns one tile of query rows of one (b, h) and walks the KV tiles
// in a loop, with the softmax state in registers.  Only the tiles that
// some row of the block can see are visited (the causal and window bounds
// of the loop), which skips what the TPU kernel skips with `pl.when`.
// Every kernel masks element by element only on tiles that cross the
// causal diagonal, the window edge or the end of the keys, takes exp2 with
// scale * log2(e) folded into one FMA, and starts the query tiles with the
// most keys first (the slow grid dimension, last tile first), so the tail
// of the grid holds the short ones.  Three kernels, chosen by the
// wrapper's `route` by dtype, D and layout:
//
//   * `flash_fwd_wgmma`: float16 or bfloat16, D % 8 == 0, D <= 256, on
//     layouts the TMA takes (dense last dimension, 16-byte aligned start
//     and strides), at width W = 64, 128 or 256; the model path.
//     FlashAttention-3's shape: a block of 3 warpgroups owns 128 query
//     rows.  What each choice does about the bound:
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
//       - D below W (8-56 at W = 64, zamba2's 112, or 72, 96, 136 ...):
//         the tensor maps have an inner dimension of D, so the 64-column
//         boxes read the columns past D as TMA's out-of-bounds zeros
//         (nothing is padded or copied in device memory), and only the
//         boxes that hold data are loaded.  Q K^T takes the ceil(D/16) k16
//         steps that hold data (at W = 256 whole panels of 4), the step
//         count a template parameter, so each count is a kernel of its own
//         with no branch in its pipeline; P V runs at N=W and its columns
//         past D are not stored.
//     The two consumers run independently, so one's softmax overlaps the
//     other's products.  FlashAttention-3's overlap inside a warpgroup
//     (the next tile's Q K^T issued before this tile's softmax) and a
//     ping-pong of the consumers on named barriers were measured slower or
//     no faster (ptxas spills the larger live set and serialises the
//     wgmma); PERF.md has the numbers.
//   * `flash_fwd_mma`: float16 or bfloat16 at D <= 256 on what the TMA
//     cannot take (D % 8 != 0, strides or a start off 16 bytes, a strided
//     last dimension), at W = 32, 64, 96, 112, 128, 160, 192 or 256.
//     Bound as above; what it does about it without the TMA:
//       - mma.sync m16n8k16: 4 warps, each 32 query rows (two 16-row
//         tiles, so every K and V fragment feeds two products) up to
//         W = 128 and 16 above (for registers), 64 keys a tile (32 at
//         256); every product runs all W/16 steps (zeros past D), so no
//         branch breaks the schedule;
//       - K and V through a 2-stage ring by cp.async, tile t + 1's copies
//         in flight during tile t's products: 16 bytes a copy where rows,
//         strides and start allow, 8 or 4 where they are only so aligned,
//         element by element otherwise; rows padded 16 bytes past W, so the
//         8 rows an ldmatrix reads fall on 8 bank groups, and zeros past
//         D.  8-byte copies cost 35 % at D=112 (1.40 against 1.04 ms);
//         16-byte copies of the covering aligned chunks, shifted into place
//         by the copying threads, measured slower still (1.61 ms at D=100),
//         and so did a 3-stage ring of 32-key tiles with one barrier a tile
//         (1.54 ms);
//       - Q's fragments by ldmatrix (kept in registers at W <= 64), K's by
//         ldmatrix, V's by ldmatrix.trans;
//       - the output staged in Q's rows, then stored through o's strides
//         16, 8, 4 or 2 bytes a copy.
//     wgmma fed by cp.async from 128 producer threads into TMA's swizzle
//     measured 22 % slower than this at D=100 (1.65 against 1.35 ms;
//     PERF.md).
//   * `flash_fwd_simt`: float32 at any D, float16 or bfloat16 above
//     D = 256, and (`flash_fwd_simt<PerTensor, DC>`, one kernel a column
//     chunk) every float8 input and every mix of types: float32 FMA, no
//     TF32, bound by the FMA rate.  A block of 4
//     warps owns 64 query rows; thread (rg, kg) holds an 8 x 4 register
//     tile of S (rows rg + 8 i, keys kg + 16 j) and an 8 x DC/16 tile of O,
//     so every 16-byte shared load feeds 8 or 16 FMAs.  DC (32, 64 or 128)
//     output columns a block, a grid dimension of ceil(D / DC) column
//     chunks over D, each recomputing S over all of D in 32-column chunks:
//     any D runs.  K chunks, V half-tiles (and Q chunks where Q does not
//     stay in shared memory with two blocks an SM) stream through a
//     3-slot ring by cp.async (16 bytes a copy where the layout allows,
//     else 4), one barrier a step; 1- and 2-byte inputs come raw by
//     cp.async (16, 8 or 4 bytes a copy, else element by element) and each
//     thread converts its own copies to float32 in shared memory, a float8
//     byte through its format's 256 values (a table per tensor in shared
//     memory, made on the host from torch's decoding).  P goes through
//     shared memory into P V.  The PerTensor kernel reads each tensor's
//     type code from Params, so 3 kernels take the 8^4 combinations; it
//     rounds its output as the reference's `astype` does (`encode_f8`:
//     to nearest even, each format's own overflow, NaN and zero).
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
  // element strides of batch, head, row and column (a dimension of size 1
  // may have any)
  int64_t q_sb, q_sh, q_ss, q_sd, k_sb, k_sh, k_ss, k_sd, v_sb, v_sh, v_ss,
      v_sd, o_sb, o_sh, o_ss, o_sd;
  // elements a copy of the mma and simt kernels moves: 16, 8, 4 or 2 (16
  // bytes' worth at most, the column stride 1, start, strides and D
  // multiples of it), or 1 (element by element, any strides)
  int q_vec, k_vec, v_vec, o_vec;
  // the type codes of q, k, v and o (read by the PerTensor simt kernel): 0
  // float32, 1 bfloat16, 2 float16, 3 float8_e4m3fn, 4 float8_e5m2, 5
  // float8_e4m3fnuz, 6 float8_e5m2fnuz, 7 float8_e8m0fnu
  int q_type, k_type, v_type, o_type;
  // the 256 values of q's, k's and v's float8 type, in device memory
  // (null for a tensor that is not float8)
  const float* lut[3];
};

// The simt kernel's element type that stands for "each tensor in the type
// its code in Params names".
struct PerTensor {};
template <typename T>
constexpr bool kPer = std::is_same_v<T, PerTensor>;

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

// Element access of the simt kernel: T's own type, or for PerTensor the
// type `code` names (a float8 byte through its 256-entry table `lut`).
template <typename T>
__device__ __forceinline__ int elem_bytes(int code) {
  if constexpr (kPer<T>) return code_bytes(code);
  else return (int)sizeof(T);
}
template <typename T>
__device__ __forceinline__ bool is_f32(int code) {
  if constexpr (kPer<T>) return code == 0;
  else return std::is_same_v<T, float>;
}
template <typename T>
__device__ __forceinline__ float load_f32(const char* p, int code,
                                          const float* lut) {
  if constexpr (kPer<T>) {
    switch (code) {
      case 0: return *reinterpret_cast<const float*>(p);
      case 1: return to_f32(*reinterpret_cast<const bf16*>(p));
      case 2: return to_f32(*reinterpret_cast<const f16*>(p));
      default: return lut[*reinterpret_cast<const uint8_t*>(p)];
    }
  } else {
    return to_f32(*reinterpret_cast<const T*>(p));
  }
}
template <typename T>
__device__ __forceinline__ void store_f32(char* p, int code, float x) {
  if constexpr (kPer<T>) {
    switch (code) {
      case 0: *reinterpret_cast<float*>(p) = x; break;
      case 1: *reinterpret_cast<bf16*>(p) = from_f32<bf16>(x); break;
      case 2: *reinterpret_cast<f16*>(p) = from_f32<f16>(x); break;
      default: *reinterpret_cast<uint8_t*>(p) = encode_f8(x, code);
    }
  } else {
    *reinterpret_cast<T*>(p) = from_f32<T>(x);
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

// Thread tid's share of `rows` x `per_row` items, i = tid, tid + kThreads,
// ...: calls f(r, j) for each, the row and column stepped without a
// division per item.
template <typename F>
__device__ __forceinline__ void for_items(int rows, int per_row, int tid,
                                          F&& f) {
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  int r = tid / per_row, j = tid - r * per_row;
  while (r < rows) {
    f(r, j);
    j += dc;
    r += dr;
    if (j >= per_row) {
      j -= per_row;
      ++r;
    }
  }
}

// ------------------------------------------------------------ float32 FMA

namespace simt {
constexpr int kBQ = 64;           // query rows a block
constexpr int kBK = 64;           // keys a tile
constexpr int kKC = 32;           // D columns of a K (or streamed Q) chunk
constexpr int kLdC = kKC + 4;     // row stride of such a chunk (floats)
constexpr int kLdP = kBK + 16;    // row stride of P: the two rows a warp
                                  // writes at once fall on other banks
// shared memory a block may take so that two fit on an SM (228 KB, less
// 1 KB reserved a block)
constexpr int kTwoBlocks = 233472 / 2 - 1024;
constexpr int kSlots = 3;         // the copy ring
// floats of a ring slot: a K chunk and a streamed Q chunk, or half a V
// tile (kBK / 2 keys x DC columns)
template <int DC>
__host__ __device__ constexpr int slot_floats() {
  return 2 * kBQ * kLdC > (kBK / 2) * (DC + 4) ? 2 * kBQ * kLdC
                                               : (kBK / 2) * (DC + 4);
}
__host__ __device__ inline int q_cols(int D) {
  return (D + kKC - 1) / kKC * kKC;
}
// floats of the raw staging of the 1- and 2-byte inputs, room for 2-byte
// elements: a K chunk (64 x 32), a streamed Q chunk (64 x 32, from byte
// kRawQ) and half a V tile at DC = 128 (32 x 128, from byte kRawV).  Each
// thread converts the copies it issued; K's, Q's and V's copies are laid
// out differently, so each has its own region, and a thread's next copies
// never land on bytes another thread has yet to convert.
constexpr int kRawFloats = 2 * kBK * kKC;
constexpr int kRawQ = kBK * kKC * 2;
constexpr int kRawV = 2 * kRawQ;
// shared memory without Q (the PerTensor kernel adds the float8 tables of
// q, k and v, 256 floats each), and whether Q (D rounded up to kKC, as
// float32) stays in shared memory: where two blocks still fit an SM; else
// its chunks stream through the ring beside K's
template <typename T, int DC>
__host__ __device__ constexpr int base_bytes() {
  return 4 * (kSlots * slot_floats<DC>() + kBQ * kLdP +
              (std::is_same_v<T, float> ? 0 : kRawFloats) +
              (kPer<T> ? 3 * 256 : 0));
}
template <typename T, int DC>
__host__ __device__ inline bool q_resident(int D) {
  return base_bytes<T, DC>() + 4 * kBQ * (q_cols(D) + 4) <= kTwoBlocks;
}
template <typename T, int DC>
size_t smem_bytes(int D) {
  return base_bytes<T, DC>() +
         (q_resident<T, DC>(D) ? 4 * kBQ * (q_cols(D) + 4) : 0);
}

// Copies the rows x cols block at columns [col0, col0 + cols) of a float32
// tensor (row r, column c at src + r * ss + c * sd) into dst (row stride ld)
// by cp.async: 16 bytes a copy when vec4 (column stride 1, start, strides
// and D multiples of 4 elements), else 4; rows from `valid` and columns from
// D on are zeros.
__device__ __forceinline__ void copy_f32(float* dst, int ld, const float* src,
                                         int64_t ss, int64_t sd, int rows,
                                         int cols, int valid, int col0, int D,
                                         bool vec4, int tid) {
  if (vec4) {
    const int per_row = cols / 4;
    for (int i = tid; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * 4, col = col0 + c;
      const bool ok = r < valid && col < D;
      cp_async<16>(smem_u32(dst + r * ld + c), ok ? src + r * ss + col : src,
                   ok);
    }
  } else {
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols, col = col0 + c;
      const bool ok = r < valid && col < D;
      cp_async<4>(smem_u32(dst + r * ld + c),
                  ok ? src + r * ss + (int64_t)col * sd : src, ok);
    }
  }
}

// The same block of a tensor of 1- or 2-byte elements (type `code`, `eb`
// bytes an element, at byte address src), converted on its way into
// shared memory.  Where `vec` elements make a copy of 16, 8 or 4 bytes
// (column stride 1, start, strides and D multiples of it) `copy_raw`
// brings the raw block into `raw` (rows x cols elements, dense) by
// cp.async, and `convert_raw`, once this thread's copies have landed,
// writes the elements it copied into dst as float32: no registers hold the
// block in between.  Otherwise (any strides) `convert_raw` loads element by
// element from src itself.  Rows from `valid` and columns from D on are
// zeros.
__device__ __forceinline__ void copy_raw(char* raw, const char* src,
                                         int64_t ss, int rows, int cols,
                                         int valid, int col0, int D, int vec,
                                         int eb, int tid) {
  const int bytes = vec * eb;
  if (bytes < 4) return;
  const int per_row = cols / vec;
  for (int i = tid; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * vec, col = col0 + c;
    const bool ok = r < valid && col < D;
    const char* g = ok ? src + (r * ss + col) * eb : src;
    const uint32_t d = smem_u32(raw + (r * cols + c) * eb);
    if (bytes == 16) cp_async<16>(d, g, ok);
    else if (bytes == 8) cp_async<8>(d, g, ok);
    else cp_async<4>(d, g, ok);
  }
}
template <typename T>
__device__ __forceinline__ void convert_raw(float* dst, int ld,
                                            const char* raw, const char* src,
                                            int64_t ss, int64_t sd, int rows,
                                            int cols, int valid, int col0,
                                            int D, int vec, int eb, int code,
                                            const float* lut, int tid) {
  if (vec * eb < 4) {
    for (int i = tid; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols, col = col0 + c;
      dst[r * ld + c] =
          r < valid && col < D
              ? load_f32<T>(src + (r * ss + (int64_t)col * sd) * eb, code, lut)
              : 0.f;
    }
    return;
  }
  const int per_row = cols / vec;
  for (int i = tid; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * vec;
    const bool ok = r < valid && col0 + c < D;  // a copy lies in D or past
    const char* x = raw + (r * cols + c) * eb;
    for (int e = 0; e < vec; ++e)
      dst[r * ld + c + e] = ok ? load_f32<T>(x + e * eb, code, lut) : 0.f;
  }
}

// Brings a block of a tensor of type `code` toward its float32 slot `dst`:
// float32 straight into it, 1- and 2-byte types into `raw` (`land` then
// converts them).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, char* raw,
                                      const char* src, int64_t ss, int64_t sd,
                                      int rows, int cols, int valid, int col0,
                                      int D, int vec, int eb, int code,
                                      int tid) {
  if (is_f32<T>(code))
    copy_f32(dst, ld, reinterpret_cast<const float*>(src), ss, sd, rows, cols,
             valid, col0, D, vec == 4, tid);
  else
    copy_raw(raw, src, ss, rows, cols, valid, col0, D, vec, eb, tid);
}
}  // namespace simt

// T: the inputs' and output's type (PerTensor: each tensor's own, by its
// code in Params); DC: the output columns a block computes (32, 64 or 128;
// a grid dimension of ceil(D / DC) column chunks covers D).
// Thread (rg, kg) = (tid / 16, tid % 16) holds rows rg + 8 i (i < 8) of the
// block: the scores of keys kg + 16 j (j < 4) of the tile, and O at
// DC / 16 columns.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_simt(const Params p) {
  using namespace simt;
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int kSlot = slot_floats<DC>();
  constexpr int kCols = DC / 16;          // O columns a thread holds
  constexpr int kLdV = DC + 4;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                     // [kSlots][kSlot]
  float* Ps = ring + kSlots * kSlot;      // [kBQ][kLdP]
  char* raw = reinterpret_cast<char*>(Ps + kBQ * kLdP);  // 1- and 2-byte
  float* luts = Ps + kBQ * kLdP + (kF32 ? 0 : kRawFloats);  // [3][256]
  float* Qs = luts + (kPer<T> ? 3 * 256 : 0);  // [kBQ][dq + 4], resident

  // each tensor's type code and element bytes (constants but for
  // PerTensor), and its float8 table in shared memory
  const int qt = kPer<T> ? p.q_type : 0, kt = kPer<T> ? p.k_type : 0,
            vt = kPer<T> ? p.v_type : 0, ot = kPer<T> ? p.o_type : 0;
  const int qb = elem_bytes<T>(qt), kb = elem_bytes<T>(kt),
            vb = elem_bytes<T>(vt), ob = elem_bytes<T>(ot);
  const float *lq = luts, *lk = luts + 256, *lv = luts + 512;
  const int tid = threadIdx.x, rg = tid >> 4, kg = tid & 15;
  if constexpr (kPer<T>) {
    const int codes[3] = {qt, kt, vt};
#pragma unroll
    for (int t = 0; t < 3; ++t)
      if (codes[t] >= 3)
        for (int i = tid; i < 256; i += kThreads)
          luts[t * 256 + i] = p.lut[t][i];
    __syncthreads();
  }

  const int D = p.D, dq = q_cols(D), nkc = dq / kKC;
  const bool q_res = q_resident<T, DC>(D);
  const int ldq = q_res ? dq + 4 : kLdC;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const char* q = (const char*)p.q + (b * p.q_sb + h * p.q_sh) * qb;
  const char* k = (const char*)p.k + (b * p.k_sb + hk * p.k_sh) * kb;
  const char* v = (const char*)p.v + (b * p.v_sb + hk * p.v_sh) * vb;
  char* o = (char*)p.o + (b * p.o_sb + h * p.o_sh) * ob;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // last tile first
  const int c0 = blockIdx.z * DC;
  const int off = p.Sk - p.Sq;
  int kbeg, kend;
  kv_range(p, q0 + off, min(q0 + kBQ, p.Sq) - 1 + off, kbeg, kend);
  const int t_first = kbeg / kBK;
  const int n_tiles = kend > kbeg ? (kend - 1) / kBK + 1 - t_first : 0;
  // each key tile is nkc steps of Q K^T over D, then two of P V
  const int spt = nkc + 2, n_steps = n_tiles * spt;

  // the first row of each tensor's block
  const char* qrow = q + q0 * p.q_ss * qb;

  // Q, converted to float32 and kept whole when it fits
  if (q_res) {
    if (is_f32<T>(qt)) {
      copy_f32(Qs, ldq, reinterpret_cast<const float*>(qrow), p.q_ss, p.q_sd,
               kBQ, dq, p.Sq - q0, 0, D, p.q_vec == 4, tid);
    } else {
      for (int i = tid; i < kBQ * dq; i += kThreads) {
        const int r = i / dq, c = i - r * dq;
        Qs[r * ldq + c] =
            q0 + r < p.Sq && c < D
                ? load_f32<T>(qrow + (r * p.q_ss + c * p.q_sd) * qb, qt, lq)
                : 0.f;
      }
    }
  }

  // issues the copies of step j: float32 into its slot, 1- and 2-byte
  // types raw into the staging
  auto issue = [&](int j) {
    float* slot = ring + (j % kSlots) * kSlot;
    const int tile = j / spt, r = j - tile * spt;
    const int k0 = (t_first + tile) * kBK;
    if (r < nkc) {
      stage<T>(slot, kLdC, raw, k + k0 * p.k_ss * kb, p.k_ss, p.k_sd, kBK,
               kKC, p.Sk - k0, r * kKC, D, p.k_vec, kb, kt, tid);
      if (!q_res)
        stage<T>(slot + kBK * kLdC, kLdC, raw + kRawQ, qrow, p.q_ss, p.q_sd,
                 kBQ, kKC, p.Sq - q0, r * kKC, D, p.q_vec, qb, qt, tid);
    } else {
      const int kv0 = k0 + (r - nkc) * (kBK / 2);
      stage<T>(slot, kLdV, raw + kRawV, v + kv0 * p.v_ss * vb, p.v_ss,
               p.v_sd, kBK / 2, DC, p.Sk - kv0, c0, D, p.v_vec, vb, vt, tid);
    }
  };
  // once this thread's copies of step j have landed, converts the 1- and
  // 2-byte ones into the step's slot
  auto land = [&](int j) {
    if constexpr (!kF32) {
      cp_wait<0>();
      float* slot = ring + (j % kSlots) * kSlot;
      const int tile = j / spt, r = j - tile * spt;
      const int k0 = (t_first + tile) * kBK;
      if (r < nkc) {
        if (!is_f32<T>(kt))
          convert_raw<T>(slot, kLdC, raw, k + k0 * p.k_ss * kb, p.k_ss,
                         p.k_sd, kBK, kKC, p.Sk - k0, r * kKC, D, p.k_vec, kb,
                         kt, lk, tid);
        if (!q_res && !is_f32<T>(qt))
          convert_raw<T>(slot + kBK * kLdC, kLdC, raw + kRawQ, qrow, p.q_ss,
                         p.q_sd, kBQ, kKC, p.Sq - q0, r * kKC, D, p.q_vec, qb,
                         qt, lq, tid);
      } else if (!is_f32<T>(vt)) {
        const int kv0 = k0 + (r - nkc) * (kBK / 2);
        convert_raw<T>(slot, kLdV, raw + kRawV, v + kv0 * p.v_ss * vb, p.v_ss,
                       p.v_sd, kBK / 2, DC, p.Sk - kv0, c0, D, p.v_vec, vb,
                       vt, lv, tid);
      }
    }
  };

  float s[8][4], acc[8][kCols], m[8], l[8];  // l: this thread's share
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)
  const float kMinusInf = __int_as_float(0xff800000);

  if (n_steps > 0) issue(0);
  cp_commit();
  if (n_steps > 0) land(0);  // after the commit: a wait sees only groups
  // One barrier a step: step j + 1's copies go into the slot of step
  // j - 2, which every thread has left once it passed step j - 1's barrier.
  for (int j = 0; j < n_steps; ++j) {
    if (j + 1 < n_steps) issue(j + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* slot = ring + (j % kSlots) * kSlot;
    const int tile = j / spt, r = j - tile * spt;
    const int k0 = (t_first + tile) * kBK;
    if (r < nkc) {
      // S += Q K^T over D columns [32 r, 32 r + 32)
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
      }
      const float* qc = q_res ? Qs + r * kKC : slot + kBK * kLdC;
#pragma unroll 2
      for (int d = 0; d < kKC; d += 4) {
        float4 kv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          kv[jj] = *reinterpret_cast<const float4*>(
              slot + (kg + 16 * jj) * kLdC + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qc + (rg + 8 * i) * ldq + d);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(qv.x, kv[jj].x, s[i][jj]);
            s[i][jj] = fmaf(qv.y, kv[jj].y, s[i][jj]);
            s[i][jj] = fmaf(qv.z, kv[jj].z, s[i][jj]);
            s[i][jj] = fmaf(qv.w, kv[jj].w, s[i][jj]);
          }
        }
      }
      if (r == nkc - 1) {
        // online softmax in base 2; the per-element mask only on a tile
        // that crosses the diagonal, the window edge or the end of the keys
        const int pos_lo = q0 + off, pos_hi = pos_lo + kBQ - 1;
        const bool edge = k0 + kBK > p.Sk ||
                          (p.causal && k0 + kBK - 1 > pos_lo) ||
                          (p.window > 0 && pos_hi - k0 >= p.window);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int qpos = q0 + rg + 8 * i + off;
          float mx = m[i];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (edge && !kept(p, qpos, k0 + kg + 16 * jj))
              s[i][jj] = kMinusInf;
            mx = fmaxf(mx, s[i][jj]);
          }
#pragma unroll
          for (int sh = 8; sh > 0; sh >>= 1)  // the 16 threads of a row
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, sh));
          const float al = ex2((m[i] - mx) * sl2), ms = mx * sl2;
          m[i] = mx;
          float rs = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float pr = ex2(fmaf(s[i][jj], sl2, -ms));
            rs += pr;
            Ps[(rg + 8 * i) * kLdP + kg + 16 * jj] = pr;
          }
          l[i] = l[i] * al + rs;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] *= al;
        }
        // P is read after the next step's barrier
      }
    } else {
      // O += P V over keys [32 h, 32 h + 32) of the tile
      const float* ps = Ps + (r - nkc) * (kBK / 2);
#pragma unroll 2
      for (int kk = 0; kk < kBK / 2; kk += 4) {
        if constexpr (kCols == 2) {
          float2 vv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vv[e] = *reinterpret_cast<const float2*>(slot + (kk + e) * kLdV +
                                                     2 * kg);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 pv = *reinterpret_cast<const float4*>(
                ps + (rg + 8 * i) * kLdP + kk);
            const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][0] = fmaf(pe[e], vv[e].x, acc[i][0]);
              acc[i][1] = fmaf(pe[e], vv[e].y, acc[i][1]);
            }
          }
        } else {
          constexpr int G = kCols / 4;
          float4 vv[4][G];
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int g = 0; g < G; ++g)
              vv[e][g] = *reinterpret_cast<const float4*>(
                  slot + (kk + e) * kLdV + 64 * g + 4 * kg);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 pv = *reinterpret_cast<const float4*>(
                ps + (rg + 8 * i) * kLdP + kk);
            const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int g = 0; g < G; ++g) {
                acc[i][4 * g + 0] = fmaf(pe[e], vv[e][g].x, acc[i][4 * g + 0]);
                acc[i][4 * g + 1] = fmaf(pe[e], vv[e][g].y, acc[i][4 * g + 1]);
                acc[i][4 * g + 2] = fmaf(pe[e], vv[e][g].z, acc[i][4 * g + 2]);
                acc[i][4 * g + 3] = fmaf(pe[e], vv[e][g].w, acc[i][4 * g + 3]);
              }
          }
        }
      }
    }
    if (j + 1 < n_steps) land(j + 1);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float tot = l[i];
#pragma unroll
    for (int sh = 8; sh > 0; sh >>= 1) tot += __shfl_xor_sync(kFull, tot, sh);
    const float inv = 1.f / (tot == 0.f ? 1.f : tot);
    const int row = q0 + rg + 8 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = c0 + (kCols == 2 ? 2 * kg + c
                                       : 64 * (c / 4) + 4 * kg + c % 4);
      if (col < D)
        store_f32<T>(o + (row * p.o_ss + col * p.o_sd) * ob, ot,
                     acc[i][c] * inv);
    }
  }
}

// --------------------------------- float16 / bfloat16 tensor cores, mma.sync

namespace tc {
// 16-row tiles of queries a warp owns at width W: two up to 128 (each K and
// V fragment then feeds two products), one above (for registers)
template <int W>
__host__ __device__ constexpr int mt() {
  return W <= 128 ? 2 : 1;
}
template <int W>
__host__ __device__ constexpr int bq() {
  return 4 * 16 * mt<W>();  // query rows a block: 4 warps
}
// keys a tile (fewer at 256, for registers)
template <int W>
__host__ __device__ constexpr int bk() {
  return W == 256 ? 32 : 64;
}
// bytes of a tile row: W columns and 16 bytes of padding, so that rows
// are an odd number of 16-byte chunks apart and the 8 rows an ldmatrix
// reads at one chunk fall on 8 bank groups (W a multiple of 16)
template <int W>
__host__ __device__ constexpr int pitch() {
  return 2 * W + 16;
}
template <int W>
constexpr size_t smem_bytes() {
  return (size_t)pitch<W>() * (bq<W>() + 4 * bk<W>());  // Q, 2 stages of
                                                         // K and V
}
// byte offset of 16-byte chunk `chunk` (columns 8 chunk ...) of row r
template <int W>
__device__ __forceinline__ int at(int r, int chunk) {
  return r * pitch<W>() + (chunk << 4);
}

// rows x D elements of a 16-bit tensor (row r, column c at src + r * ss +
// c * sd) into the tile `dst`; rows from `valid` on are zeros.
// vec 8, 4 or 2 (elements a copy; column stride 1, and start, strides and D
// multiples of it) copies by cp.async of 16, 8 or 4 bytes; vec 1 loads
// element by element through registers (any start, any strides).
template <int W, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const uint16_t* src, int64_t ss,
                                          int64_t sd, int valid, int D,
                                          int vec, int tid) {
  if (vec == 1) {
    for_items(ROWS, D, tid, [&](int r, int c) {
      *reinterpret_cast<uint16_t*>(dst + at<W>(r, c >> 3) + (c & 7) * 2) =
          r < valid ? src[r * ss + (int64_t)c * sd] : uint16_t(0);
    });
    return;
  }
  for_items(ROWS, D / vec, tid, [&](int r, int j) {
    const int c = j * vec;
    const bool ok = r < valid;
    const uint16_t* g = ok ? src + r * ss + c : src;
    const uint32_t s = smem_u32(dst + at<W>(r, c >> 3) + (c & 7) * 2);
    if (vec == 8) cp_async<16>(s, g, ok);
    else if (vec == 4) cp_async<8>(s, g, ok);
    else cp_async<4>(s, g, ok);
  });
}

// zeros in columns [D, W) of a tile's rows: the products run all W
// columns
template <int W>
__device__ __forceinline__ void zero_pad(unsigned char* tile, int rows, int D,
                                         int tid) {
  if (D < W)
    for_items(rows, W - D, tid, [&](int r, int j) {
      const int c = D + j;
      *reinterpret_cast<uint16_t*>(tile + at<W>(r, c >> 3) + (c & 7) * 2) =
          0;
    });
}
}  // namespace tc

// c += a (16x16, row) * b (16x8, col) in T (f16 or bf16), float32
// accumulate.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
#define FLASH_MMA(TY)                                                      \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "  \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"   \
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (kIsF16<T>) FLASH_MMA("f16");
  else FLASH_MMA("bf16");
#undef FLASH_MMA
}

// T: f16 or bf16; W: the pipeline width (32, 64, 96, 112, 128, 160, 192
// or 256), any D <= W.  Warp w owns query rows MT 16 w ... of the block, in MT tiles of
// 16; every product runs all W / 16 steps (the columns past D are zeros),
// so no branch breaks the schedule.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, W <= 128 ? 2 : 1)
    flash_fwd_mma(const Params p) {
  using namespace tc;
  constexpr int MT = mt<W>(), BQ = bq<W>(), BK = bk<W>();
  constexpr int NT = BK / 8;             // 8-key tiles of S
  constexpr int KS = W / 16;             // k16 steps of Q K^T, 16-column
                                         // pairs of P V
  constexpr bool kQRegs = W <= 64;       // Q's fragments kept in registers
  constexpr int kTileQ = BQ * pitch<W>(), kTileKV = BK * pitch<W>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_raw;          // [BQ][W + 8]
  unsigned char* Ks = Qs + kTileQ;       // [2 stages][BK][W + 8]
  unsigned char* Vs = Ks + 2 * kTileKV;  // [2 stages][BK][W + 8]

  const int D = p.D;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const uint16_t* q = (const uint16_t*)p.q + b * p.q_sb + h * p.q_sh;
  const uint16_t* k = (const uint16_t*)p.k + b * p.k_sb + hk * p.k_sh;
  const uint16_t* v = (const uint16_t*)p.v + b * p.v_sb + hk * p.v_sh;
  uint16_t* o = (uint16_t*)p.o + b * p.o_sb + h * p.o_sh;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last tile first
  const int off = p.Sk - p.Sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;    // mma fragment coordinates
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row and matrix
  const int wr = warp * 16 * MT;            // this warp's first row
  const int pos_lo = q0 + wr + off, pos_hi = pos_lo + 16 * MT - 1;
  int kbeg, kend;
  kv_range(p, q0 + off, min(q0 + BQ, p.Sq) - 1 + off, kbeg, kend);
  const int t_first = kbeg / BK;
  const int n_tiles = kend > kbeg ? (kend - 1) / BK + 1 - t_first : 0;

  zero_pad<W>(Qs, BQ, D, tid);
  zero_pad<W>(Ks, 2 * BK, D, tid);
  zero_pad<W>(Vs, 2 * BK, D, tid);
  load_tile<W, BQ>(Qs, q + q0 * p.q_ss, p.q_ss, p.q_sd, p.Sq - q0, D,
                   p.q_vec, tid);
  auto load_kv = [&](int it) {
    const int k0 = (t_first + it) * BK, s = it & 1;
    load_tile<W, BK>(Ks + s * kTileKV, k + k0 * p.k_ss, p.k_ss, p.k_sd,
                     p.Sk - k0, D, p.k_vec, tid);
    load_tile<W, BK>(Vs + s * kTileKV, v + k0 * p.v_ss, p.v_ss, p.v_sd,
                     p.Sk - k0, D, p.v_vec, tid);
  };
  if (n_tiles > 0) load_kv(0);
  cp_commit();

  float acc[MT][W / 8][4];
  float m[MT][2], l[MT][2];  // rows g and g + 8 of each tile: running max
                             // (raw logits), this thread's share of the sum
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    m[mi][0] = m[mi][1] = kNegInf;
    l[mi][0] = l[mi][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < W / 8; ++dt)
      acc[mi][dt][0] = acc[mi][dt][1] = acc[mi][dt][2] = acc[mi][dt][3] = 0.f;
  }
  uint32_t qf[kQRegs ? MT : 1][kQRegs ? KS : 1][4];
  const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)
  const float kMinusInf = __int_as_float(0xff800000);
  const uint32_t q_base = smem_u32(Qs);
  // this lane's ldmatrix row of Q's A fragments (matrix lm: rows + 8 (lm &
  // 1), columns + 8 (lm >> 1))
  const int q_row = wr + lr + ((lm & 1) << 3);

  for (int it = 0; it < n_tiles; ++it) {
    // tile it + 1 goes into the other stage, freed by the last barrier
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int s = it & 1;
    const int k0 = (t_first + it) * BK;
    const uint32_t kb = smem_u32(Ks + s * kTileKV);
    const uint32_t vb = smem_u32(Vs + s * kTileKV);
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            ldsm_x4(q_base + at<W>(q_row + 16 * mi, 2 * kk + (lm >> 1)),
                    qf[mi][kk]);
      }
    }

    // S = Q K^T (16 MT rows x BK keys a warp)
    float sc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        sc[mi][nt][0] = sc[mi][nt][1] = sc[mi][nt][2] = sc[mi][nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if constexpr (kQRegs) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[mi][x] = qf[mi][kk][x];
        } else {
          ldsm_x4(q_base + at<W>(q_row + 16 * mi, 2 * kk + (lm >> 1)),
                  a[mi]);
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // keys 16 np + 8 (lm >> 1) + lr, columns 16 kk + 8 (lm & 1): the
        // b0, b1 fragments of key tiles 2 np and 2 np + 1
        uint32_t bf[4];
        ldsm_x4(kb + at<W>(16 * np + ((lm >> 1) << 3) + lr, 2 * kk + (lm & 1)),
                bf);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma16816<T>(sc[mi][2 * np], a[mi], bf[0], bf[1]);
          mma16816<T>(sc[mi][2 * np + 1], a[mi], bf[2], bf[3]);
        }
      }
    }

    // the per-element mask, only where the tile crosses the diagonal, the
    // window edge or the end of the keys for some row of this warp
    const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > pos_lo) ||
                      (p.window > 0 && pos_hi - k0 >= p.window);
    float al[MT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int qp0 = pos_lo + 16 * mi + g, qp1 = qp0 + 8;
      if (edge) {
        // key base + c of a row is kept iff lo <= c <= hi
        const int base = k0 + 2 * t;
        const int hi0 = min(p.Sk - 1, p.causal ? qp0 : 0x7fffffff) - base;
        const int hi1 = min(p.Sk - 1, p.causal ? qp1 : 0x7fffffff) - base;
        const int lo0 =
            p.window > 0 ? qp0 - p.window + 1 - base : -0x7fffffff;
        const int lo1 =
            p.window > 0 ? qp1 - p.window + 1 - base : -0x7fffffff;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * nt + e;
            if (c > hi0 || c < lo0) sc[mi][nt][e] = kMinusInf;
            if (c > hi1 || c < lo1) sc[mi][nt][2 + e] = kMinusInf;
          }
        }
      }

      // online softmax in base 2: p = 2^(s * sl2 - m * sl2)
      float mx0 = m[mi][0], mx1 = m[mi][1];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(sc[mi][nt][0], sc[mi][nt][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[mi][nt][2], sc[mi][nt][3]));
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {  // the 4 threads of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, sh));
      }
      al[mi][0] = ex2((m[mi][0] - mx0) * sl2);
      al[mi][1] = ex2((m[mi][1] - mx1) * sl2);
      m[mi][0] = mx0;
      m[mi][1] = mx1;
      const float ms0 = mx0 * sl2, ms1 = mx1 * sl2;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[mi][nt][e] = ex2(fmaf(sc[mi][nt][e], sl2, -ms0));
          sc[mi][nt][2 + e] = ex2(fmaf(sc[mi][nt][2 + e], sl2, -ms1));
          rs0 += sc[mi][nt][e];
          rs1 += sc[mi][nt][2 + e];
        }
      }
      l[mi][0] = l[mi][0] * al[mi][0] + rs0;
      l[mi][1] = l[mi][1] * al[mi][1] + rs1;
#pragma unroll
      for (int dt = 0; dt < W / 8; ++dt) {
        acc[mi][dt][0] *= al[mi][0];
        acc[mi][dt][1] *= al[mi][0];
        acc[mi][dt][2] *= al[mi][1];
        acc[mi][dt][3] *= al[mi][1];
      }
    }

    // O += P V: P (16 x BK a tile, in T) from the S registers; V's B
    // fragments by ldmatrix.trans, two 8-column tiles at a time
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        a[mi][0] = pack<T>(sc[mi][2 * kc][0], sc[mi][2 * kc][1]);
        a[mi][1] = pack<T>(sc[mi][2 * kc][2], sc[mi][2 * kc][3]);
        a[mi][2] = pack<T>(sc[mi][2 * kc + 1][0], sc[mi][2 * kc + 1][1]);
        a[mi][3] = pack<T>(sc[mi][2 * kc + 1][2], sc[mi][2 * kc + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        // keys 16 kc + 8 (lm & 1) + lr, columns 16 dp + 8 (lm >> 1)
        uint32_t bf[4];
        ldsm_x4_t(vb + at<W>(16 * kc + ((lm & 1) << 3) + lr, 2 * dp + (lm >> 1)),
                  bf);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma16816<T>(acc[mi][2 * dp], a[mi], bf[0], bf[1]);
          mma16816<T>(acc[mi][2 * dp + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this stage may be refilled
  }
  cp_wait<0>();
  __syncthreads();  // every copy has landed: Q's rows may be reused

  // epilogue: normalise, stage this warp's rows in its own Q rows, then
  // copy them out through o's strides with o's widest copy
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    float l0 = l[mi][0], l1 = l[mi][1];
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      l0 += __shfl_xor_sync(kFull, l0, sh);
      l1 += __shfl_xor_sync(kFull, l1, sh);
    }
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    const int r0 = wr + 16 * mi + g;
#pragma unroll
    for (int dt = 0; dt < W / 8; ++dt) {
      if (8 * dt >= D) continue;
      *reinterpret_cast<uint32_t*>(Qs + at<W>(r0, dt) + 4 * t) =
          pack<T>(acc[mi][dt][0] * inv0, acc[mi][dt][1] * inv0);
      *reinterpret_cast<uint32_t*>(Qs + at<W>(r0 + 8, dt) + 4 * t) =
          pack<T>(acc[mi][dt][2] * inv1, acc[mi][dt][3] * inv1);
    }
  }
  __syncwarp();
  const int ov = p.o_vec, per_row = D / ov;
  for (int i = lane; i < 16 * MT * per_row; i += 32) {
    const int r = i / per_row, c = (i - r * per_row) * ov;
    const int row = q0 + wr + r;
    if (row >= p.Sq) continue;
    const unsigned char* sp = Qs + at<W>(wr + r, c >> 3) + (c & 7) * 2;
    uint16_t* gp = o + row * p.o_ss + (int64_t)c * p.o_sd;
    if (ov == 8) *reinterpret_cast<uint4*>(gp) = *reinterpret_cast<const uint4*>(sp);
    else if (ov == 4) *reinterpret_cast<uint2*>(gp) = *reinterpret_cast<const uint2*>(sp);
    else if (ov == 2) *reinterpret_cast<uint32_t*>(gp) = *reinterpret_cast<const uint32_t*>(sp);
    else *gp = *reinterpret_cast<const uint16_t*>(sp);
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
// 128-byte swizzle, columns past D and rows past S read as zeros.  A
// dimension of size 1 (stride 0 here) gets the stride of a dense layout.
template <typename T>
bool encode(CUtensorMap* map, const void* base, int D, int S, int heads,
            int B, int64_t sb, int64_t sh, int64_t ss, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  if (S == 1) ss = D;
  if (heads == 1) sh = ss * S;
  if (B == 1) sb = sh * heads;
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

template <typename T, int DC>
int launch_simt(const Params& p, cudaStream_t stream) {
  static bool attr = false;
  const int e = set_smem(flash_fwd_simt<T, DC>, attr, simt::kTwoBlocks);
  if (e) return e;
  const dim3 grid(p.B * p.H, (p.Sq + simt::kBQ - 1) / simt::kBQ,
                  (p.D + DC - 1) / DC);
  flash_fwd_simt<T, DC>
      <<<grid, kThreads, simt::smem_bytes<T, DC>(p.D), stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_mma(const Params& p, cudaStream_t stream) {
  static bool attr = false;
  const int e = set_smem(flash_fwd_mma<T, W>, attr, tc::smem_bytes<W>());
  if (e) return e;
  const dim3 grid(p.B * p.H, (p.Sq + tc::bq<W>() - 1) / tc::bq<W>());
  flash_fwd_mma<T, W><<<grid, kThreads, tc::smem_bytes<W>(), stream>>>(p);
  return (int)cudaGetLastError();
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

// The wgmma kernel for D at width W, by the k16 steps of its Q K^T: each
// step count is a kernel of its own, so no branch sits in the pipeline and
// each keeps the registers of one product chain (one kernel with a branch
// between step counts spilled 2.2 KB at W = 256 and ran D=112 3 % slower).
// W = 64 takes D 8-64 at 1-4 steps, W = 128 D 72-128 at 5-8; at W = 256
// the steps come in whole panels, 12 or 16.  10 wgmma kernels a type.
template <typename T>
int launch_wgmma_d(const Params& p, int width, cudaStream_t st) {
  const int ks = (p.D + 15) / 16;
  if (width == 64) {
    switch (ks) {
      case 1: return launch_wgmma<T, 64, 1>(p, st);
      case 2: return launch_wgmma<T, 64, 2>(p, st);
      case 3: return launch_wgmma<T, 64, 3>(p, st);
      case 4: return launch_wgmma<T, 64, 4>(p, st);
    }
  }
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

// variant 0 = simt (column chunk 32, 64 or 128 for float32, 128 for a
// 16-bit type), 1 = mma (W 32, 64, 96, 112, 128, 160, 192, 256; 16-bit),
// 2 = wgmma (W 64, 128, 256; 16-bit)
template <typename T>
int launch_t(const Params& p, int variant, int width, cudaStream_t st) {
  if constexpr (std::is_same_v<T, float>) {
    if (variant != 0) return (int)cudaErrorInvalidValue;
    switch (width) {
      case 32: return launch_simt<T, 32>(p, st);
      case 64: return launch_simt<T, 64>(p, st);
      case 128: return launch_simt<T, 128>(p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    if (variant == 0)
      return width == 128 ? launch_simt<T, 128>(p, st)
                          : (int)cudaErrorInvalidValue;
    if (p.D > width) return (int)cudaErrorInvalidValue;
    if (variant == 1) {
      switch (width) {
        case 32: return launch_mma<T, 32>(p, st);
        case 64: return launch_mma<T, 64>(p, st);
        case 96: return launch_mma<T, 96>(p, st);
        case 112: return launch_mma<T, 112>(p, st);
        case 128: return launch_mma<T, 128>(p, st);
        case 160: return launch_mma<T, 160>(p, st);
        case 192: return launch_mma<T, 192>(p, st);
        case 256: return launch_mma<T, 256>(p, st);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    if (variant == 2) {
      if (p.D % 8 || p.q_sd != 1 || p.k_sd != 1 || p.v_sd != 1 ||
          p.o_sd != 1)
        return (int)cudaErrorInvalidValue;
      return launch_wgmma_d<T>(p, width, st);
    }
    return (int)cudaErrorInvalidValue;
  }
}

// the PerTensor simt kernel at column chunk `width`
int launch_per_tensor(const Params& p, int width, cudaStream_t st) {
  switch (width) {
    case 32: return launch_simt<PerTensor, 32>(p, st);
    case 64: return launch_simt<PerTensor, 64>(p, st);
    case 128: return launch_simt<PerTensor, 128>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool copy_ok(int vec, int D, int64_t sd, int type) {
  return vec == 1 ||
         ((vec == 2 || vec == 4 || vec == 8 || vec == 16) && D % vec == 0 &&
          sd == 1 && vec * code_bytes(type) <= 16);
}

}  // namespace

// q (B,H,Sq,D), k and v (B,Hkv,Sk,D), o (B,H,Sq,D), each addressed by its
// element strides (batch, head, row, column; `strides` holds 16 of them in
// the order q, k, v, o), on the current device; `vecs` holds q's, k's, v's
// and o's elements a copy and `types` their type codes (see Params); `luts`
// q's, k's and v's float8 tables (null for one that is not float8).
// variant:
//   0 = simt, float32 FMA: float32 at any D (width 32, 64 or 128: the
//       output columns a block computes, D beyond it split over the grid),
//       16-bit types at D > 256 (width 128), and (PerTensor, width 32, 64
//       or 128) any other types: a float8 tensor or a mix; any strides;
//   1 = mma.sync: q, k, v, o of one 16-bit type, D <= width (32, 64, 96,
//       112, 128, 160, 192 or 256), any strides;
//   2 = TMA + wgmma: q, k, v, o of one 16-bit type, D % 8 == 0 and D <=
//       width (64, 128 or 256), column stride 1, 16-byte aligned starts and
//       other strides (what the TMA and the 16-byte stores take; the caller
//       checks).
// B*H may be any int; Sq at most 65535 query tiles of 64 (128 for wgmma).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments no kernel takes.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      const int64_t* strides, const int* vecs,
                                      int causal, int window, float scale,
                                      const int* types,
                                      const float* const* luts, int variant,
                                      int width, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      window < 0 || D < 1 || variant < 0 || variant > 2 ||
      (int64_t)B * H > 0x7fffffff || (Sq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  bool one_type = true;
  for (int i = 0; i < 4; ++i) {
    if (types[i] < 0 || types[i] > 7 ||
        (i < 3 && types[i] >= 3 && luts[i] == nullptr))
      return (int)cudaErrorInvalidValue;
    one_type = one_type && types[i] == types[0];
  }
  const int64_t* s = strides;
  const Params p{q,       k,        v,        o,        B,        H,
                 Hkv,     Sq,       Sk,       D,        causal ? 1 : 0,
                 window,  scale,    s[0],     s[1],     s[2],     s[3],
                 s[4],    s[5],     s[6],     s[7],     s[8],     s[9],
                 s[10],   s[11],    s[12],    s[13],    s[14],    s[15],
                 vecs[0], vecs[1],  vecs[2],  vecs[3],  types[0], types[1],
                 types[2], types[3], {luts[0], luts[1], luts[2]}};
  if (!copy_ok(p.q_vec, D, p.q_sd, p.q_type) ||
      !copy_ok(p.k_vec, D, p.k_sd, p.k_type) ||
      !copy_ok(p.v_vec, D, p.v_sd, p.v_type) ||
      !copy_ok(p.o_vec, D, p.o_sd, p.o_type))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (one_type && types[0] <= 2) {
    switch (types[0]) {
      case 0: return launch_t<float>(p, variant, width, st);
      case 1: return launch_t<bf16>(p, variant, width, st);
      default: return launch_t<f16>(p, variant, width, st);
    }
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return launch_per_tensor(p, width, st);
}
