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
// of the grid holds the short ones.  Three kernels here, chosen by the
// wrapper's `route` by the compute type C of q, k and v (`compute_code`:
// float16 or bfloat16, into which every operand decodes exactly), D and
// layout; the sets whose C is tf32 (bfloat16 beside float16, float16
// beside e8m0fnu) run flash_tf32.cu's kernel on the TMA's layouts at
// D <= 128, and `flash_fwd_simt<PerTensor, DC>` otherwise; the helpers
// both sources use are in flash_common.cuh.  The two 16-bit tensor-core
// kernels run every set with a 16-bit C; where
// some operand is float8 (DEC), it is decoded into C on its way into
// shared memory, with no table (`dec4`: e4m3fn and e5m2 by the hardware's
// cvt to f16x2, the others from their bits), and the output is rounded
// to q's type (`encode_f8` for a float8 q):
//
//   * `flash_fwd_wgmma`: C exists, D % 8 == 0, D <= 256, on layouts the
//     TMA takes (dense last dimension, 16-byte aligned start and strides
//     in each tensor's own bytes), at width W = 64, 128 or 256; the model
//     path.
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
//     A float8 operand comes raw by TMA (a UINT8 map: 64 bytes a row,
//     into raw stages, two at W <= 128 and one at W = 256 for shared
//     memory) and the producer warpgroup's 128 threads, idle in the
//     16-bit kernel, decode it into the swizzled 16-bit tile and fence the
//     async proxy before they signal it (`decode_tile`).
//     The two consumers run independently, so one's softmax overlaps the
//     other's products.  FlashAttention-3's overlap inside a warpgroup
//     (the next tile's Q K^T issued before this tile's softmax) and a
//     ping-pong of the consumers on named barriers were measured slower or
//     no faster (ptxas spills the larger live set and serialises the
//     wgmma); PERF.md has the numbers.
//   * `flash_fwd_mma`: C exists, D <= 256, on what the TMA cannot take
//     (D % 8 != 0, strides or a start off 16 bytes, a strided last
//     dimension), at W = 32, 64, 96, 112, 128, 160, 192 or 256.  A
//     float8 K or V comes raw by cp.async into two raw stages behind one
//     decoded tile (the shared memory of the 16-bit ring, so two blocks
//     still fit an SM), decoded 16 bytes a thread after a barrier
//     (`copy_raw8`, `decode_raw`; through registers instead measured
//     slower); a float8 Q is decoded once through registers.
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
//     chunk) every set with float32 in a mix, the tf32 sets off the tf32
//     kernel's route and every float8 set above D = 256: float32 FMA, no
//     TF32, bound by the FMA rate.  A block of 4
//     warps owns 64 query rows; thread (rg, kg) holds an 8 x 4 register
//     tile of S (rows rg + 8 i, keys kg + 16 j) and an 8 x DC/16 tile of O,
//     so every 16-byte shared load feeds 8 or 16 FMAs.  DC (32, 64 or 128)
//     output columns a block, a grid dimension of ceil(D / DC) column
//     chunks over D, each recomputing S over all of D in 32-column chunks:
//     any D runs.  Q stays in shared memory as float32, converted once a
//     block, where two blocks still fit an SM (D <= 128 with 16-bit K and
//     V: `simt::layout` sizes every region to the call's types); K
//     chunks, V half-tiles (and Q chunks where Q does not stay) stream
//     through a 3-slot ring by cp.async (16 bytes a copy where the layout
//     allows, else 4), one barrier a step; 1- and 2-byte inputs come raw
//     by cp.async (16, 8 or 4 bytes a copy, else element by element) and
//     each thread converts its own copies to float32 in shared memory,
//     halfway through the step before them (the copies have landed by
//     then, and the conversion runs beside the other warps' FMAs), in a
//     loop compiled for the tensor's type (`with_type`: one branch a
//     tensor, uniform over the block) that decodes 16 raw bytes at a time
//     and stores 16 bytes of float32 at a time, float8 from its bits
//     (`dec4_f32`, no table).  P goes through shared memory into P V.
//     The PerTensor kernel reads each tensor's type code from Params, so
//     3 kernels take the 8^4 combinations; it rounds its output as the
//     reference's `astype` does (`encode_f8`: to nearest even, each
//     format's own overflow, NaN and zero).
//
// 16-bit products are exact in float32, so Q K^T differs from the
// reference only in summation order; P is rounded to C for the P V
// product (the row sums use the unrounded P), a relative error of 2^-9 a
// weight in bfloat16 and 2^-11 in float16, inside the tolerances of 2e-2
// and 5e-3.  Native float8 products would run at twice the rate, but an
// fp8 P V would round P to 3 mantissa bits.  Blocks above 48 KB of shared
// memory are allowed once per instantiation with cudaFuncSetAttribute;
// the TMA descriptors are
// encoded on the host at every call and passed by value, so a captured
// CUDA graph keeps them.
#include "flash_common.cuh"

namespace {

// The simt kernel's element type that stands for "each tensor in the type
// its code in Params names".
struct PerTensor {};
template <typename T>
constexpr bool kPer = std::is_same_v<T, PerTensor>;

// The type code of the simt kernel's T (PerTensor: none, each tensor has
// its own in Params).
template <typename T>
constexpr int kCodeOf = std::is_same_v<T, float>  ? 0
                        : std::is_same_v<T, bf16> ? 1
                        : kIsF16<T>               ? 2
                                                  : -1;

// Calls f(std::integral_constant<int, CODE>) for a tensor of type code
// `code` of the simt kernel: T's own code, or for PerTensor `code` (a
// branch uniform over the block), so each loop over its elements is
// compiled once a type.
template <typename T, typename F>
__device__ __forceinline__ void with_type(int code, F&& f) {
  if constexpr (kPer<T>) with_any_code(code, f);
  else f(std::integral_constant<int, kCodeOf<T>>{});
}

// float32 x stored at p in type CODE, rounded as the reference rounds
template <int CODE>
__device__ __forceinline__ void store_as(unsigned char* p, float x) {
  if constexpr (CODE == 0) *reinterpret_cast<float*>(p) = x;
  else if constexpr (CODE == 1) *reinterpret_cast<bf16*>(p) = from_f32<bf16>(x);
  else if constexpr (CODE == 2) *reinterpret_cast<f16*>(p) = from_f32<f16>(x);
  else *p = encode_f8(x, CODE);
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
__host__ __device__ inline int q_cols(int D) {
  return (D + kKC - 1) / kKC * kKC;
}

// A block's shared memory at column chunk DC for head dim D and q's, k's
// and v's bytes an element (4: float32, which needs no staging), in order:
//   the ring, kSlots slots of `slot` floats: a K chunk (kBK x kKC, rows
//     kLdC apart) and, where Q streams, a Q chunk behind it; or half a V
//     tile (kBK / 2 keys x DC, dense rows: the threads that read a row
//     read the same row);
//   P, [kBQ][kLdP] floats;
//   the raw copies of the 1- and 2-byte inputs, in their own bytes: a K
//     chunk (from byte raw_k of the region), a streamed Q chunk (raw_q)
//     and half a V tile (raw_v).  Each thread converts the copies it
//     issued; K's, Q's and V's copies are laid out differently, so each
//     has its own region, and a thread's next copies never land on bytes
//     another thread has yet to convert;
//   Q (from byte q_off), [kBQ][q_cols(D) + 4] floats converted once a
//     block (`q_res`), where two blocks still fit an SM with it; else its
//     chunks stream through the ring beside K's.
// Resident, Q needs no raw region and the ring's slots no room for its
// chunks: at D = 128, DC = 128 with 16-bit K and V that is 115,712 bytes,
// two blocks an SM.
struct Layout {
  int slot, raw_k, raw_q, raw_v, q_off, bytes;
  bool q_res;
};
__host__ __device__ inline Layout layout(int DC, int D, int qb, int kb,
                                         int vb) {
  const int vhalf = (kBK / 2) * DC;
  const int rk = kb < 4 ? kBK * kKC * kb : 0;
  const int rv = vb < 4 ? (kBK / 2) * DC * vb : 0;
  const int q_bytes = 4 * kBQ * (q_cols(D) + 4);
  Layout L;
  L.slot = kBK * kLdC > vhalf ? kBK * kLdC : vhalf;
  L.q_res = 4 * (kSlots * L.slot + kBQ * kLdP) + rk + rv + q_bytes <=
            kTwoBlocks;
  if (!L.q_res && 2 * kBK * kLdC > L.slot) L.slot = 2 * kBK * kLdC;
  const int rq = L.q_res || qb == 4 ? 0 : kBQ * kKC * qb;
  L.raw_k = 0;
  L.raw_q = rk;
  L.raw_v = rk + rq;
  L.q_off = 4 * (kSlots * L.slot + kBQ * kLdP) + rk + rq + rv;
  L.bytes = L.q_off + (L.q_res ? q_bytes : 0);
  return L;
}

// log2 of a power of two, at compile time
__host__ __device__ constexpr int log2i(int x) {
  return x > 1 ? 1 + log2i(x / 2) : 0;
}

// The row r and column c of item i of a block `cols` wide, `vec` columns
// an item: by shifts where COLS, the block's width (a power of two, as vec
// is), is known at compile time, as for the blocks of every step; by a
// division otherwise (COLS = 0: Q's D columns, once a block).
template <int COLS>
__device__ __forceinline__ void item_at(int i, int cols, int vec, int& r,
                                        int& c) {
  if constexpr (COLS > 0) {
    const int lv = __ffs(vec) - 1, sh = log2i(COLS) - lv;
    r = i >> sh;
    c = (i & ((1 << sh) - 1)) << lv;
  } else {
    const int per_row = cols / vec;
    r = i / per_row;
    c = (i - r * per_row) * vec;
  }
}

// Copies the rows x cols block at columns [col0, col0 + cols) of a float32
// tensor (row r, column c at src + r * ss + c * sd) into dst (row stride ld)
// by cp.async: 16 bytes a copy when vec4 (column stride 1, start, strides
// and D multiples of 4 elements), else 4; rows from `valid` and columns from
// D on are zeros.  (Indexed by `item_at`'s shifts this measured slower
// in simt<float>: the division stays.)
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

// Calls f(std::integral_constant<int, N>) for a copy of `bytes` = 16, 8 or
// 4, so each loop over copies is compiled for its size.
template <typename F>
__device__ __forceinline__ void with_copy_bytes(int bytes, F&& f) {
  if (bytes == 16) f(std::integral_constant<int, 16>{});
  else if (bytes == 8) f(std::integral_constant<int, 8>{});
  else f(std::integral_constant<int, 4>{});
}

// The same block of a tensor of 1- or 2-byte elements (`eb` bytes an
// element, at byte address src), converted on its way into shared memory.
// Where `vec` elements make a copy of 16, 8 or 4 bytes (column stride 1,
// start, strides and D multiples of it) `copy_raw` brings the raw block
// into `raw` (rows x cols elements, dense) by cp.async, and `convert`,
// once this thread's copies have landed, writes the elements it copied
// into dst as float32: no registers hold the block in between.  Otherwise
// (any strides) `convert` loads element by element from src itself.
// Rows from `valid` and columns from D on are zeros.  Both loops are
// compiled for the copy's size.
template <int COLS>
__device__ __forceinline__ void copy_raw(unsigned char* raw,
                                         const unsigned char* src, int64_t ss,
                                         int rows, int cols, int valid,
                                         int col0, int D, int vec, int eb,
                                         int tid) {
  if (vec * eb < 4) return;
  with_copy_bytes(vec * eb, [&](auto nv) {
    constexpr int N = decltype(nv)::value;
    for (int i = tid; i < rows * cols / vec; i += kThreads) {
      int r, c;
      item_at<COLS>(i, cols, vec, r, c);
      const int col = col0 + c;
      const bool ok = r < valid && col < D;
      cp_async<N>(smem_u32(raw + (r * cols + c) * eb),
                  ok ? src + (r * ss + col) * eb : src, ok);
    }
  });
}
// The block in type CODE (1-7) as float32 into dst: each copy of `vec`
// elements that this thread issued decoded from `raw` (or, where raw is
// null, read from src itself in the same pieces: Q, once a block) and
// stored 16 bytes at a time (`store_decoded`); element by element from src
// where no copy of 4 bytes or more takes the layout.  One loop a type and
// copy size: no test of either, and no table, inside.  (Four copies'
// loads in flight before the first store measured slower: more
// registers, no latency to hide.)
template <int CODE, int COLS>
__device__ __forceinline__ void convert(float* dst, int ld,
                                        const unsigned char* raw,
                                        const unsigned char* src, int64_t ss,
                                        int64_t sd, int rows, int cols,
                                        int valid, int col0, int D, int vec,
                                        int tid) {
  constexpr int EB = kBytes<CODE>;
  if (vec * EB < 4) {
    for (int i = tid; i < rows * cols; i += kThreads) {
      int r, c;
      item_at<COLS>(i, cols, 1, r, c);
      const int col = col0 + c;
      float x = 0.f;
      if (r < valid && col < D) {
        const unsigned char* e = src + (r * ss + (int64_t)col * sd) * EB;
        x = dec1<CODE>(EB == 2 ? *reinterpret_cast<const uint16_t*>(e) : *e);
      }
      dst[r * ld + c] = x;
    }
    return;
  }
  with_copy_bytes(vec * EB, [&](auto nv) {
    constexpr int N = decltype(nv)::value;
    for (int i = tid; i < rows * cols / vec; i += kThreads) {
      int r, c;
      item_at<COLS>(i, cols, vec, r, c);
      const bool ok = r < valid && col0 + c < D;  // in D or past, whole
      store_decoded<CODE, N>(
          dst + r * ld + c,
          ok ? load_copy<N>(raw ? raw + (r * cols + c) * EB
                                : src + (r * ss + col0 + c) * EB)
             : make_uint4(0, 0, 0, 0),
          ok);
    }
  });
}

// Brings a block of a tensor of type `code` toward its float32 slot `dst`:
// float32 straight into it, 1- and 2-byte types into `raw` (`land` then
// converts them).
template <int COLS>
__device__ __forceinline__ void stage(float* dst, int ld, unsigned char* raw,
                                      const unsigned char* src, int64_t ss,
                                      int64_t sd, int rows, int valid,
                                      int col0, int D, int vec, int code,
                                      int tid) {
  if (code == 0)
    copy_f32(dst, ld, reinterpret_cast<const float*>(src), ss, sd, rows,
             COLS, valid, col0, D, vec == 4, tid);
  else
    copy_raw<COLS>(raw, src, ss, rows, COLS, valid, col0, D, vec,
                   code_bytes(code), tid);
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
  constexpr int kCols = DC / 16;          // O columns a thread holds
  constexpr int kLdV = DC;
  extern __shared__ __align__(16) float smem[];

  // each tensor's type code and element bytes (constants but for
  // PerTensor)
  const int qt = kPer<T> ? p.q_type : kCodeOf<T>,
            kt = kPer<T> ? p.k_type : kCodeOf<T>,
            vt = kPer<T> ? p.v_type : kCodeOf<T>,
            ot = kPer<T> ? p.o_type : kCodeOf<T>;
  const int qb = code_bytes(qt), kb = code_bytes(kt), vb = code_bytes(vt);
  const int tid = threadIdx.x, rg = tid >> 4, kg = tid & 15;
  const int D = p.D, dq = q_cols(D), nkc = dq / kKC;
  const Layout L = layout(DC, D, qb, kb, vb);
  const int kSlot = L.slot;
  const bool q_res = L.q_res;
  float* ring = smem;                     // [kSlots][kSlot]
  float* Ps = ring + kSlots * kSlot;      // [kBQ][kLdP]
  unsigned char* raw = reinterpret_cast<unsigned char*>(Ps + kBQ * kLdP);
  float* Qs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(smem) +
                                       L.q_off);  // [kBQ][dq + 4], resident
  const int ldq = q_res ? dq + 4 : kLdC;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const unsigned char* q =
      (const unsigned char*)p.q + (b * p.q_sb + h * p.q_sh) * qb;
  const unsigned char* k =
      (const unsigned char*)p.k + (b * p.k_sb + hk * p.k_sh) * kb;
  const unsigned char* v =
      (const unsigned char*)p.v + (b * p.v_sb + hk * p.v_sh) * vb;

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
  const unsigned char* qrow = q + q0 * p.q_ss * qb;

  // Q, converted to float32 once and kept whole when it fits (a float32
  // Q by cp.async, in the first copy group)
  if (q_res)
    with_type<T>(qt, [&](auto cv) {
      constexpr int CODE = decltype(cv)::value;
      if constexpr (CODE == 0)
        copy_f32(Qs, ldq, reinterpret_cast<const float*>(qrow), p.q_ss,
                 p.q_sd, kBQ, dq, p.Sq - q0, 0, D, p.q_vec == 4, tid);
      else
        convert<CODE, 0>(Qs, ldq, nullptr, qrow, p.q_ss, p.q_sd, kBQ, dq,
                         p.Sq - q0, 0, D, p.q_vec, tid);
    });

  // A step is named by its tile, its place r in the tile (nkc steps of
  // Q K^T, then two of P V) and its ring slot.
  // issues the copies of a step: float32 into its slot, 1- and 2-byte
  // types raw into the staging
  auto issue = [&](int tile, int r, float* slot)
                   __attribute__((always_inline)) {
    const int k0 = (t_first + tile) * kBK;
    if (r < nkc) {
      stage<kKC>(slot, kLdC, raw + L.raw_k, k + k0 * p.k_ss * kb, p.k_ss,
                 p.k_sd, kBK, p.Sk - k0, r * kKC, D, p.k_vec, kt, tid);
      if (!q_res)
        stage<kKC>(slot + kBK * kLdC, kLdC, raw + L.raw_q, qrow, p.q_ss,
                   p.q_sd, kBQ, p.Sq - q0, r * kKC, D, p.q_vec, qt, tid);
    } else {
      const int kv0 = k0 + (r - nkc) * (kBK / 2);
      stage<DC>(slot, kLdV, raw + L.raw_v, v + kv0 * p.v_ss * vb, p.v_ss,
                p.v_sd, kBK / 2, p.Sk - kv0, c0, D, p.v_vec, vt, tid);
    }
  };
  // once this thread's copies of a step have landed, converts the 1- and
  // 2-byte ones into the step's slot, each tensor by the loop of its type
  // (inlined: as a call it saved the live registers on the stack and
  // the PerTensor kernel ran slower)
  auto land = [&](int tile, int r, float* slot)
                  __attribute__((always_inline)) {
    if constexpr (!kF32) {
      cp_wait<0>();
      const int k0 = (t_first + tile) * kBK;
      if (r < nkc) {
        with_type<T>(kt, [&](auto cv) {
          constexpr int CODE = decltype(cv)::value;
          if constexpr (CODE != 0)
            convert<CODE, kKC>(slot, kLdC, raw + L.raw_k,
                               k + k0 * p.k_ss * kb, p.k_ss, p.k_sd, kBK,
                               kKC, p.Sk - k0, r * kKC, D, p.k_vec, tid);
        });
        if (!q_res)
          with_type<T>(qt, [&](auto cv) {
            constexpr int CODE = decltype(cv)::value;
            if constexpr (CODE != 0)
              convert<CODE, kKC>(slot + kBK * kLdC, kLdC, raw + L.raw_q,
                                 qrow, p.q_ss, p.q_sd, kBQ, kKC, p.Sq - q0,
                                 r * kKC, D, p.q_vec, tid);
          });
      } else {
        const int kv0 = k0 + (r - nkc) * (kBK / 2);
        with_type<T>(vt, [&](auto cv) {
          constexpr int CODE = decltype(cv)::value;
          if constexpr (CODE != 0)
            convert<CODE, DC>(slot, kLdV, raw + L.raw_v,
                              v + kv0 * p.v_ss * vb, p.v_ss, p.v_sd, kBK / 2,
                              DC, p.Sk - kv0, c0, D, p.v_vec, tid);
        });
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

  if (n_steps > 0) issue(0, 0, ring);
  cp_commit();
  if (n_steps > 0) land(0, 0, ring);  // after the commit: a wait sees
                                      // only groups
  // One barrier a step: step j + 1's copies go into the slot of step
  // j - 2, which every thread has left once it passed step j - 1's barrier.
  // They are issued before step j's products and converted after them,
  // when they have had the step's time to land.  Step j is (tile, r) in
  // slot `cur`; the next step's indices are stepped, not divided.
  int tile = 0, r = 0, cur = 0;
  for (int j = 0; j < n_steps; ++j) {
    const bool more = j + 1 < n_steps;
    const int nxt = cur == kSlots - 1 ? 0 : cur + 1;
    const int ntile = r + 1 == spt ? tile + 1 : tile;
    const int nr = r + 1 == spt ? 0 : r + 1;
    float* next = ring + nxt * kSlot;
    if (more) issue(ntile, nr, next);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* slot = ring + cur * kSlot;
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
            vv[e] = *reinterpret_cast<const float2*>(
                slot + (kk + e) * kLdV + 2 * kg);
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
    if (more) land(ntile, nr, next);
    tile = ntile;
    r = nr;
    cur = nxt;
  }
  cp_wait<0>();

  // the output in o's type, the rounding compiled once a type
  with_type<T>(ot, [&](auto cv) {
    constexpr int CODE = decltype(cv)::value;
    unsigned char* o = (unsigned char*)p.o +
                       (b * p.o_sb + h * p.o_sh) * kBytes<CODE>;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float tot = l[i];
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        tot += __shfl_xor_sync(kFull, tot, sh);
      const float inv = 1.f / (tot == 0.f ? 1.f : tot);
      const int row = q0 + rg + 8 * i;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = c0 + (kCols == 2 ? 2 * kg + c
                                         : 64 * (c / 4) + 4 * kg + c % 4);
        if (col < D)
          store_as<CODE>(o + (row * p.o_ss + col * p.o_sd) * kBytes<CODE>,
                         acc[i][c] * inv);
      }
    }
  });
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

// A float8 operand of the mma kernel.  `copy_raw8` brings rows x D bytes
// (row r, column c at src + r * ss + c) raw into `raw` (row r at r * W) by
// cp.async of `vec` bytes (16, 8 or 4: column stride 1, start, strides
// and D multiples of it); rows from `valid` on are zeros.
template <int W, int ROWS>
__device__ __forceinline__ void copy_raw8(unsigned char* raw,
                                          const unsigned char* src,
                                          int64_t ss, int valid, int D,
                                          int vec, int tid) {
  for_items(ROWS, D / vec, tid, [&](int r, int j) {
    const int c = j * vec;
    const bool ok = r < valid;
    const unsigned char* g = ok ? src + r * ss + c : src;
    const uint32_t s = smem_u32(raw + r * W + c);
    if (vec == 16) cp_async<16>(s, g, ok);
    else if (vec == 8) cp_async<8>(s, g, ok);
    else cp_async<4>(s, g, ok);
  });
}

// Decodes the raw stage `raw` (rows x D float8 bytes of type CODE, row r
// at r * W, as `copy_raw8` brought them) into the 16-bit tile `dst`, 16
// bytes at a time whatever the copies' width (a thread reads other
// threads' copies: the caller has passed a barrier); the columns from D
// on, which no copy wrote, come out zero.
template <typename T, int CODE, int W, int ROWS>
__device__ __forceinline__ void decode_raw(unsigned char* dst,
                                           const unsigned char* raw, int D,
                                           int tid) {
  for_items(ROWS, (D + 15) / 16, tid, [&](int r, int j) {
    const int c = 16 * j;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + r * W + c);
    uint32_t o[8];
    dec4<T, CODE>(w.x, o[0], o[1]);
    dec4<T, CODE>(w.y, o[2], o[3]);
    dec4<T, CODE>(w.z, o[4], o[5]);
    dec4<T, CODE>(w.w, o[6], o[7]);
    if (c + 16 > D) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (c + 2 * e >= D) o[e] = 0;
        else if (c + 2 * e + 1 >= D) o[e] &= 0xffffu;
      }
    }
    uint4* d = reinterpret_cast<uint4*>(dst + at<W>(r, c >> 3));
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  });
}

// Decodes rows x D float8 bytes of type CODE (row r, column c at src +
// r * ss + c * sd, in device memory, any strides) into the 16-bit tile
// `dst` byte by byte through registers; rows from `valid` on are zeros.
// For the layouts no copy of 4 bytes or more takes.
template <typename T, int CODE, int W, int ROWS>
__device__ __forceinline__ void decode_rows(unsigned char* dst,
                                            const unsigned char* src,
                                            int64_t ss, int64_t sd, int valid,
                                            int D, int tid) {
  for_items(ROWS, D, tid, [&](int r, int c) {
    uint32_t lo = 0, hi;
    if (r < valid) dec4<T, CODE>(src[r * ss + c * sd], lo, hi);
    *reinterpret_cast<uint16_t*>(dst + at<W>(r, c >> 3) + (c & 7) * 2) =
        (uint16_t)lo;
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

// T: f16 or bf16, the compute type; W: the pipeline width (32, 64, 96,
// 112, 128, 160, 192 or 256), any D <= W.  Warp w owns query rows MT 16 w
// ... of the block, in MT tiles of 16; every product runs all W / 16 steps
// (the columns past D are zeros), so no branch breaks the schedule.  DEC:
// some of q, k, v is float8 (its code in Params), decoded into T on its
// way into shared memory; the others are T, and the output is q's type.
template <typename T, int W, bool DEC>
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
  // K and V: 2 stages of [BK][W + 8] each; a float8 operand instead keeps
  // one decoded tile there and, behind it, 2 raw stages of [BK][W] bytes
  unsigned char* Ks = Qs + kTileQ;
  unsigned char* Vs = Ks + 2 * kTileKV;

  // which inputs come as float8 (constant false but for DEC), and each
  // tensor's bytes an element
  const bool qd = DEC && p.q_type >= 3, kd = DEC && p.k_type >= 3,
             vd = DEC && p.v_type >= 3;
  const int qe = qd ? 1 : 2, ke = kd ? 1 : 2, ve = vd ? 1 : 2;
  const int D = p.D;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const unsigned char* q =
      (const unsigned char*)p.q + (b * p.q_sb + h * p.q_sh) * qe;
  const unsigned char* k =
      (const unsigned char*)p.k + (b * p.k_sb + hk * p.k_sh) * ke;
  const unsigned char* v =
      (const unsigned char*)p.v + (b * p.v_sb + hk * p.v_sh) * ve;
  unsigned char* o = (unsigned char*)p.o + (b * p.o_sb + h * p.o_sh) * qe;

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

  // the zeros past D of every 16-bit tile (a float8 operand's one decoded
  // tile only: its raw stages must take no stray stores), K's and V's
  // after a float8 Q, whose raw rows pass through K's second half
  zero_pad<W>(Qs, BQ, D, tid);
  if constexpr (DEC) {
    if (qd)
      with_code<T>(p.q_type, [&](auto c) {
        constexpr int CODE = decltype(c)::value;
        if (p.q_vec > 1) {
          // raw by cp.async into K's second half (BQ x W bytes fit: it
          // holds 2 BK rows of W + 8 elements, or of W bytes), free
          // until tile 0's copies; decoded once all have landed
          unsigned char* raw = Ks + kTileKV;
          copy_raw8<W, BQ>(raw, q + q0 * p.q_ss, p.q_ss, p.Sq - q0, D,
                           p.q_vec, tid);
          cp_commit();
          cp_wait<0>();
          __syncthreads();
          decode_raw<T, CODE, W, BQ>(Qs, raw, D, tid);
          __syncthreads();  // every thread has read the raw rows
        } else {
          decode_rows<T, CODE, W, BQ>(Qs, q + q0 * p.q_ss, p.q_ss, p.q_sd,
                                      p.Sq - q0, D, tid);
        }
      });
  }
  if (!qd)
    load_tile<W, BQ>(Qs, (const uint16_t*)q + q0 * p.q_ss, p.q_ss, p.q_sd,
                     p.Sq - q0, D, p.q_vec, tid);
  zero_pad<W>(Ks, kd ? BK : 2 * BK, D, tid);
  zero_pad<W>(Vs, vd ? BK : 2 * BK, D, tid);
  // tile it's copies: a 16-bit operand into stage it & 1, a float8 one raw
  // into raw stage it & 1 (nothing where it goes element by element)
  auto load_kv = [&](int it) {
    const int k0 = (t_first + it) * BK, s = it & 1;
    if (!kd)
      load_tile<W, BK>(Ks + s * kTileKV, (const uint16_t*)k + k0 * p.k_ss,
                       p.k_ss, p.k_sd, p.Sk - k0, D, p.k_vec, tid);
    else if (p.k_vec > 1)
      copy_raw8<W, BK>(Ks + kTileKV + s * BK * W, k + k0 * p.k_ss, p.k_ss,
                       p.Sk - k0, D, p.k_vec, tid);
    if (!vd)
      load_tile<W, BK>(Vs + s * kTileKV, (const uint16_t*)v + k0 * p.v_ss,
                       p.v_ss, p.v_sd, p.Sk - k0, D, p.v_vec, tid);
    else if (p.v_vec > 1)
      copy_raw8<W, BK>(Vs + kTileKV + s * BK * W, v + k0 * p.v_ss, p.v_ss,
                       p.Sk - k0, D, p.v_vec, tid);
  };
  // once every thread's copies of tile it have landed (a barrier), decodes
  // a float8 operand's into its one decoded tile (every thread left that
  // tile at the last barrier of tile it - 1); generic, so only DEC
  // compiles it
  auto decode_kv = [&](auto it) {
    const int k0 = (t_first + it) * BK, s = it & 1;
    if (kd)
      with_code<T>(p.k_type, [&](auto c) {
        constexpr int CODE = decltype(c)::value;
        if (p.k_vec > 1)
          decode_raw<T, CODE, W, BK>(Ks, Ks + kTileKV + s * BK * W, D, tid);
        else
          decode_rows<T, CODE, W, BK>(Ks, k + k0 * p.k_ss, p.k_ss, p.k_sd,
                                      p.Sk - k0, D, tid);
      });
    if (vd)
      with_code<T>(p.v_type, [&](auto c) {
        constexpr int CODE = decltype(c)::value;
        if (p.v_vec > 1)
          decode_raw<T, CODE, W, BK>(Vs, Vs + kTileKV + s * BK * W, D, tid);
        else
          decode_rows<T, CODE, W, BK>(Vs, v + k0 * p.v_ss, p.v_ss, p.v_sd,
                                      p.Sk - k0, D, tid);
      });
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
    if constexpr (DEC) {
      if (kd || vd) {
        __syncthreads();
        decode_kv(it);
      }
    }
    __syncthreads();
    const int s = it & 1;
    const int k0 = (t_first + it) * BK;
    const uint32_t kb = smem_u32(kd ? Ks : Ks + s * kTileKV);
    const uint32_t vb = smem_u32(vd ? Vs : Vs + s * kTileKV);
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

  // epilogue: normalise, stage this warp's rows in its own Q rows (a
  // float8 output rounded as the reference rounds, a byte a column, the
  // encoder compiled once a format), then copy them out through o's
  // strides with o's widest copy
  auto stage_out = [&](auto cv) {
    constexpr int CODE = decltype(cv)::value;  // 0: o is T
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
        if constexpr (CODE != 0) {
          const int c = 8 * dt + 2 * t;
          *reinterpret_cast<uint16_t*>(Qs + r0 * pitch<W>() + c) =
              encode_f8x2<CODE>(acc[mi][dt][0] * inv0,
                                acc[mi][dt][1] * inv0);
          *reinterpret_cast<uint16_t*>(Qs + (r0 + 8) * pitch<W>() + c) =
              encode_f8x2<CODE>(acc[mi][dt][2] * inv1,
                                acc[mi][dt][3] * inv1);
        } else {
          *reinterpret_cast<uint32_t*>(Qs + at<W>(r0, dt) + 4 * t) =
              pack<T>(acc[mi][dt][0] * inv0, acc[mi][dt][1] * inv0);
          *reinterpret_cast<uint32_t*>(Qs + at<W>(r0 + 8, dt) + 4 * t) =
              pack<T>(acc[mi][dt][2] * inv1, acc[mi][dt][3] * inv1);
        }
      }
    }
  };
  if constexpr (DEC) {
    if (qd) with_code<T>(p.q_type, stage_out);
    else stage_out(std::integral_constant<int, 0>{});
  } else {
    stage_out(std::integral_constant<int, 0>{});
  }
  __syncwarp();
  const int ov = p.o_vec, per_row = D / ov, cb = ov * qe;  // bytes a copy
  for (int i = lane; i < 16 * MT * per_row; i += 32) {
    const int r = i / per_row, c = (i - r * per_row) * ov;
    const int row = q0 + wr + r;
    if (row >= p.Sq) continue;
    const unsigned char* sp = Qs + (wr + r) * pitch<W>() + c * qe;
    unsigned char* gp = o + (row * p.o_ss + (int64_t)c * p.o_sd) * qe;
    if (cb == 16) *reinterpret_cast<uint4*>(gp) = *reinterpret_cast<const uint4*>(sp);
    else if (cb == 8) *reinterpret_cast<uint2*>(gp) = *reinterpret_cast<const uint2*>(sp);
    else if (cb == 4) *reinterpret_cast<uint32_t*>(gp) = *reinterpret_cast<const uint32_t*>(sp);
    else if (cb == 2) *reinterpret_cast<uint16_t*>(gp) = *reinterpret_cast<const uint16_t*>(sp);
    else *gp = *sp;
  }
}

// ------------------ float16 / bfloat16 tensor cores, TMA + wgmma (Hopper)

// The registers of the wgmma kernel's warpgroups where the producer
// decodes float8 (DEC): of the 168 a thread holds at launch (65,536 over
// 384 threads, in steps of 8), 56 for the producer and 224 for each
// consumer (40 / 232, the 16-bit kernel's split, measured no faster)
constexpr int kDecProducerRegs = 56, kDecConsumerRegs = 224;
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
// A float8 K or V tile as the TMA brings it (DEC): boxes of 64 bytes a
// row, in raw stages of their own; two where shared memory holds them, one
// at W = 256 (two would take 241 KB of the 227 KB a block may have)
template <int W>
__host__ __device__ constexpr int raw_bytes() {
  return bk<W>() * W;
}
template <int W>
__host__ __device__ constexpr int raw_stages() {
  return W == 256 ? 1 : 2;
}
template <int W, bool DEC>
constexpr size_t smem_bytes() {
  // 1024 bytes of slack to align the swizzled tiles, then Q, the K ring,
  // the V ring, (DEC) the raw stages of K and V, and 7 (DEC 12) mbarriers
  return 1024 + q_bytes<W>() + 2 * kStages * kv_bytes<W>() +
         (DEC ? 2 * raw_stages<W>() * raw_bytes<W>() + 128 : 64);
}
}  // namespace wg

// Decodes ROWS rows of a float8 tile of type `code` as the TMA brought it
// (box c of 64 columns at raw + RAW_PANEL c, 64 bytes a row) into the
// 16-bit tile that the wgmma descriptors read (panel c at dst + DST_PANEL
// c, 128 bytes a row, 16-byte chunk j of row r at 16 (j ^ (r & 7)): the
// TMA's 128-byte swizzle; ROWS a multiple of 8 rows into a panel).  Thread
// tid of a warpgroup's 128 takes 16 raw bytes at a time, neighbours on
// neighbouring bytes; the two chunks it writes fall on other banks than
// its neighbours'.  Columns from D on are written as zeros (byte 0 of
// e8m0fnu is 2^-127, not 0).
template <typename T, int PANELS, int ROWS, int DST_PANEL = ROWS * 128,
          int RAW_PANEL = ROWS * 64>
__device__ __forceinline__ void decode_tile(unsigned char* dst,
                                            const unsigned char* raw,
                                            int code, int D, int tid) {
  with_code<T>(code, [&](auto cv) {
    constexpr int CODE = decltype(cv)::value;
#pragma unroll 2
    for (int i = tid; i < PANELS * ROWS * 4; i += 128) {
      const int c = i / (ROWS * 4), r = (i / 4) % ROWS, j = i % 4;
      const uint4 x = *reinterpret_cast<const uint4*>(
          raw + c * RAW_PANEL + r * 64 + 16 * j);
      uint4 a, b;  // columns 16 j ... + 7 and 16 j + 8 ... + 15 of box c
      dec4<T, CODE>(x.x, a.x, a.y);
      dec4<T, CODE>(x.y, a.z, a.w);
      dec4<T, CODE>(x.z, b.x, b.y);
      dec4<T, CODE>(x.w, b.z, b.w);
      const int col = 64 * c + 16 * j;
      if (col + 8 >= D) {
        b = make_uint4(0, 0, 0, 0);
        if (col >= D) a = b;
      }
      unsigned char* row = dst + c * DST_PANEL + r * wg::kPanelRow;
      *reinterpret_cast<uint4*>(row + (((2 * j) ^ (r & 7)) << 4)) = a;
      *reinterpret_cast<uint4*>(row + (((2 * j + 1) ^ (r & 7)) << 4)) = b;
    }
  });
}

// A consumer warpgroup's 64 rows of a float8 Q (`decode_tile` over the
// 128-row panels), out of line: the consumer's main loop keeps its own
// register allocation
template <typename T, int PANELS>
__device__ __noinline__ void decode_q_rows(unsigned char* dst,
                                           const unsigned char* raw,
                                           int code, int D, int tid) {
  decode_tile<T, PANELS, 64, wg::kBQ * wg::kPanelRow, wg::kBQ * 64>(
      dst, raw, code, D, tid);
}

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

// T: f16 or bf16, the compute type; W: the pipeline width (64, 128 or
// 256); KS: the k16 steps of Q K^T, ceil(D/16) (at W = 256 rounded up to
// 12 or 16, whole panels); D, a multiple of 8, in (16 (KS - 1), 16 KS] at
// W <= 128 and in (W/2, W] at W = 256 (64 at W = 64).  DEC: some of q, k,
// v is float8 (its code in Params): the TMA brings its bytes raw (a UINT8
// tensor map, no swizzle) into raw stages, and the producer warpgroup's
// 128 threads decode them into the swizzled 16-bit tiles the consumers
// read, Q once a block, K and V a tile at a time (`decode_tile`), then
// fence the async proxy (the consumers' wgmma reads those tiles through
// it) before they arrive on q_full / k_full / v_full; the producer runs at
// 56 registers and the consumers at 224.  A 16-bit operand of the same
// call keeps its direct TMA load.  The output is q's type: a float8 o is
// rounded by `encode_f8` and stored 8 bytes at a time.
template <typename T, int W, int KS, bool DEC>
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
  constexpr int kRaw = raw_stages<W>();
  const int D = p.D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + q_bytes<W>();                // [stage]
  unsigned char* Vs = Ks + kStages * kv_bytes<W>();     // [stage]
  // DEC: the raw stages of a float8 K and V, and a float8 Q's boxes (in
  // V's stage 1, free until tile 1)
  unsigned char* QR = Vs + kv_bytes<W>();
  unsigned char* KR = Vs + kStages * kv_bytes<W>();     // [raw stage]
  unsigned char* VR = KR + kRaw * raw_bytes<W>();       // [raw stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      DEC ? VR + kRaw * raw_bytes<W>() : KR);
  uint64_t* k_full = q_full + 1;                        // [stage]
  uint64_t* v_full = k_full + kStages;                  // [stage]
  uint64_t* empty = v_full + kStages;                   // [stage]
  uint64_t* rq_full = empty + kStages;                  // DEC
  uint64_t* rk_full = rq_full + 1;                      // DEC [raw stage]
  uint64_t* rv_full = rk_full + kRaw;                   // DEC [raw stage]
  // which inputs come as float8 (constant false but for DEC)
  const bool qd = DEC && p.q_type >= 3, kd = DEC && p.k_type >= 3,
             vd = DEC && p.v_type >= 3;

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
    // a decoded tile is complete when the 128 threads that decode it have
    // arrived: the producer's for K and V; Q's, each consumer decoding its
    // own rows, is done when all 256 consumer threads have (the producer
    // then may refill V's stage 1)
    mbar_init(q_full, qd ? 256 : 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], kd ? 128 : 1);
      mbar_init(&v_full[s], vd ? 128 : 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    if constexpr (DEC) {
      mbar_init(rq_full, 1);
      for (int r = 0; r < kRaw; ++r) {
        mbar_init(&rk_full[r], 1);
        mbar_init(&rv_full[r], 1);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: one thread issues every load; a box counts its whole
    // size, columns past D included (TMA's zero fill)
    if constexpr (!DEC) {
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
          unsigned char* kdst = Ks + s * kv_bytes<W>();
          unsigned char* vdst = Vs + s * kv_bytes<W>();
          mbar_expect_tx(&k_full[s], kPanels * kKPanel);
          for (int c = 0; c < kPanels; ++c)
            tma_load(kdst + c * kKPanel, &tk, &k_full[s], 64 * c, k0, hk, b);
          mbar_expect_tx(&v_full[s], kPanels * kKPanel);
          for (int c = 0; c < kPanels; ++c)
            tma_load(vdst + c * kKPanel, &tv, &v_full[s], 64 * c, k0, hk, b);
        }
      }
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   ::"n"(kDecProducerRegs));
      constexpr int kRawBox = BK * 64;        // bytes of a raw K or V box
      // thread 0: the loads of tile it's 16-bit operands into stage
      // it % 2 (free: the caller has waited on `empty`)
      auto issue_direct = [&](int it) {
        const int s = it % kStages, k0 = (t_first + it) * BK;
        if (!kd) {
          mbar_expect_tx(&k_full[s], kPanels * kKPanel);
          for (int c = 0; c < kPanels; ++c)
            tma_load(Ks + s * kv_bytes<W>() + c * kKPanel, &tk, &k_full[s],
                     64 * c, k0, hk, b);
        }
        if (!vd) {
          mbar_expect_tx(&v_full[s], kPanels * kKPanel);
          for (int c = 0; c < kPanels; ++c)
            tma_load(Vs + s * kv_bytes<W>() + c * kKPanel, &tv, &v_full[s],
                     64 * c, k0, hk, b);
        }
      };
      // thread 0: the raw loads of tile it's float8 operands
      auto issue_raw = [&](int it) {
        const int r = it % kRaw, k0 = (t_first + it) * BK;
        if (kd) {
          mbar_expect_tx(&rk_full[r], kPanels * kRawBox);
          for (int c = 0; c < kPanels; ++c)
            tma_load(KR + r * raw_bytes<W>() + c * kRawBox, &tk, &rk_full[r],
                     64 * c, k0, hk, b);
        }
        if (vd) {
          mbar_expect_tx(&rv_full[r], kPanels * kRawBox);
          for (int c = 0; c < kPanels; ++c)
            tma_load(VR + r * raw_bytes<W>() + c * kRawBox, &tv, &rv_full[r],
                     64 * c, k0, hk, b);
        }
      };
      if (tid == 0) {
        if (qd) {
          mbar_expect_tx(rq_full, kPanels * kBQ * 64);
          for (int c = 0; c < kPanels; ++c)
            tma_load(QR + c * kBQ * 64, &tq, rq_full, 64 * c, q0, h, b);
        } else {
          mbar_expect_tx(q_full, kPanels * kQPanel);
          for (int c = 0; c < kPanels; ++c)
            tma_load(Qs + c * kQPanel, &tq, q_full, 64 * c, q0, h, b);
        }
        for (int it = 0; it < min(kRaw, n_tiles); ++it) issue_raw(it);
        // tile 0's 16-bit loads too (tile 1's wait: V's stage 1 holds Q's
        // boxes until the consumers have decoded them)
        if (n_tiles > 0) issue_direct(0);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, r = it % kRaw;
        const uint32_t use = it / kStages, raw_use = it / kRaw;
        unsigned char* kdst = Ks + s * kv_bytes<W>();
        unsigned char* vdst = Vs + s * kv_bytes<W>();
        mbar_wait(&empty[s], (use & 1) ^ 1);  // the first use passes
        if (qd && it == 1) mbar_wait(q_full, 0);  // Q's boxes are read
        if (tid == 0 && it > 0) issue_direct(it);
        if (kd) {
          mbar_wait(&rk_full[r], raw_use & 1);
          decode_tile<T, kPanels, BK>(kdst, KR + r * raw_bytes<W>(), p.k_type,
                                      D, tid);
          fence_async_smem();
          mbar_arrive(&k_full[s]);
        }
        if (vd) {
          mbar_wait(&rv_full[r], raw_use & 1);
          decode_tile<T, kPanels, BK>(vdst, VR + r * raw_bytes<W>(), p.v_type,
                                      D, tid);
          fence_async_smem();
          mbar_arrive(&v_full[s]);
        }
        // every thread has read raw stage r: thread 0 refills it
        asm volatile("bar.sync 3, 128;\n" ::: "memory");
        if (tid == 0 && it + kRaw < n_tiles) issue_raw(it + kRaw);
      }
    }
  } else {
    // ---- consumer warpgroup cw: query rows q0 + 64 cw ... + 63
    if constexpr (DEC)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   ::"n"(kDecConsumerRegs));
    else asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
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

    if (qd) {
      // a float8 Q: this warpgroup decodes its own 64 rows, beside the
      // producer's decoding of K and V, and fences them for its wgmma
      if constexpr (DEC) {
        mbar_wait(rq_full, 0);
        decode_q_rows<T, kPanels>(Qs + cw * 64 * kPanelRow,
                                  QR + cw * 64 * 64, p.q_type, D, tid);
        fence_async_smem();
        mbar_arrive(q_full);
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      }
    } else {
      mbar_wait(q_full, 0);
    }
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
    if constexpr (DEC) {
      if (qd) {
        // a float8 o: each pair of columns rounded as the reference rounds
        // into two bytes, staged at row r of panel c at 128 r, 16-byte chunk
        // u (columns 16 u ... of the panel) at 16 (u ^ (r & 7)); then the
        // first D bytes of each row in 8-byte stores; the encoder compiled
        // once a format, its constants folded
        with_code<T>(p.q_type, [&](auto cv) {
          constexpr int CODE = decltype(cv)::value;
#pragma unroll
          for (int j = 0; j < kChunks; ++j) {
            if (8 * j >= D) continue;
            unsigned char* a = orow + (j >> 3) * kQPanel + r0 * kPanelRow +
                               ((((j & 7) >> 1) ^ (r0 & 7)) << 4) +
                               8 * (j & 1) + 2 * t;
            *reinterpret_cast<uint16_t*>(a) = encode_f8x2<CODE>(
                acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
            *reinterpret_cast<uint16_t*>(a + 8 * kPanelRow) = encode_f8x2<CODE>(
                acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
          }
        });
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
        unsigned char* o = (unsigned char*)p.o + b * p.o_sb + h * p.o_sh;
        const int n8 = D / 8;                 // 8-byte pieces of a row
        for (int c = tid; c < 64 * n8; c += 128) {
          const int r = c / n8, j = c % n8;   // columns 8 j ... 8 j + 7
          const int row = q0 + 64 * cw + r;
          if (row < p.Sq)
            *reinterpret_cast<uint2*>(o + row * p.o_ss + 8 * j) =
                *reinterpret_cast<const uint2*>(
                    orow + (j >> 3) * kQPanel + r * kPanelRow +
                    ((((j & 7) >> 1) ^ (r & 7)) << 4) + 8 * (j & 1));
        }
        return;
      }
    }
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

template <typename T, int DC>
int launch_simt(const Params& p, cudaStream_t stream) {
  static bool attr = false;
  const int e = set_smem(flash_fwd_simt<T, DC>, attr, simt::kTwoBlocks);
  if (e) return e;
  const dim3 grid(p.B * p.H, (p.Sq + simt::kBQ - 1) / simt::kBQ,
                  (p.D + DC - 1) / DC);
  const simt::Layout L =
      simt::layout(DC, p.D, code_bytes(p.q_type), code_bytes(p.k_type),
                   code_bytes(p.v_type));
  flash_fwd_simt<T, DC><<<grid, kThreads, L.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int W, bool DEC>
int launch_mma(const Params& p, cudaStream_t stream) {
  static bool attr = false;
  const int e = set_smem(flash_fwd_mma<T, W, DEC>, attr, tc::smem_bytes<W>());
  if (e) return e;
  const dim3 grid(p.B * p.H, (p.Sq + tc::bq<W>() - 1) / tc::bq<W>());
  flash_fwd_mma<T, W, DEC>
      <<<grid, kThreads, tc::smem_bytes<W>(), stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int W, int KS, bool DEC>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using namespace wg;
  static bool attr = false;
  const int e = set_smem(flash_fwd_wgmma<T, W, KS, DEC>, attr,
                         smem_bytes<W, DEC>());
  if (e) return e;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, p.q, p.q_type, p.D, p.Sq, p.H, p.B, p.q_sb, p.q_sh,
              p.q_ss, kBQ) ||
      !encode(&tk, p.k, p.k_type, p.D, p.Sk, p.Hkv, p.B, p.k_sb, p.k_sh,
              p.k_ss, bk<W>()) ||
      !encode(&tv, p.v, p.v_type, p.D, p.Sk, p.Hkv, p.B, p.v_sb, p.v_sh,
              p.v_ss, bk<W>()))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd_wgmma<T, W, KS, DEC>
      <<<grid, wg::kThreads, smem_bytes<W, DEC>(), stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// The wgmma kernel for D at width W, by the k16 steps of its Q K^T: each
// step count is a kernel of its own, so no branch sits in the pipeline and
// each keeps the registers of one product chain (one kernel with a branch
// between step counts spilled 2.2 KB at W = 256 and ran D=112 3 % slower).
// W = 64 takes D 8-64 at 1-4 steps, W = 128 D 72-128 at 5-8; at W = 256
// the steps come in whole panels, 12 or 16.  10 wgmma kernels a type, and
// 10 more a compute type that decode float8 (DEC).
template <typename T, bool DEC>
int launch_wgmma_d(const Params& p, int width, cudaStream_t st) {
  const int ks = (p.D + 15) / 16;
  if (width == 64) {
    switch (ks) {
      case 1: return launch_wgmma<T, 64, 1, DEC>(p, st);
      case 2: return launch_wgmma<T, 64, 2, DEC>(p, st);
      case 3: return launch_wgmma<T, 64, 3, DEC>(p, st);
      case 4: return launch_wgmma<T, 64, 4, DEC>(p, st);
    }
  }
  if (width == 128 && ks >= 5) {
    switch (ks) {
      case 5: return launch_wgmma<T, 128, 5, DEC>(p, st);
      case 6: return launch_wgmma<T, 128, 6, DEC>(p, st);
      case 7: return launch_wgmma<T, 128, 7, DEC>(p, st);
      case 8: return launch_wgmma<T, 128, 8, DEC>(p, st);
    }
  }
  if (width == 256 && ks >= 9) {
    if (ks <= 12) return launch_wgmma<T, 256, 12, DEC>(p, st);
    if (ks <= 16) return launch_wgmma<T, 256, 16, DEC>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernels of compute type T: variant 1 = mma (W 32, 64,
// 96, 112, 128, 160, 192, 256), 2 = wgmma (W 64, 128, 256; D % 8 == 0,
// column strides 1); DEC where some input is float8.
template <typename T, bool DEC>
int launch_tc(const Params& p, int variant, int width, cudaStream_t st) {
  if (p.D > width) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    switch (width) {
      case 32: return launch_mma<T, 32, DEC>(p, st);
      case 64: return launch_mma<T, 64, DEC>(p, st);
      case 96: return launch_mma<T, 96, DEC>(p, st);
      case 112: return launch_mma<T, 112, DEC>(p, st);
      case 128: return launch_mma<T, 128, DEC>(p, st);
      case 160: return launch_mma<T, 160, DEC>(p, st);
      case 192: return launch_mma<T, 192, DEC>(p, st);
      case 256: return launch_mma<T, 256, DEC>(p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (variant == 2) {
    if (p.D % 8 || p.q_sd != 1 || p.k_sd != 1 || p.v_sd != 1 || p.o_sd != 1)
      return (int)cudaErrorInvalidValue;
    return launch_wgmma_d<T, DEC>(p, width, st);
  }
  return (int)cudaErrorInvalidValue;
}

// variant 0 = simt (column chunk 32, 64 or 128 for float32, 128 for a
// 16-bit type), 1 = mma, 2 = wgmma (16-bit, `launch_tc`)
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
    return launch_tc<T, false>(p, variant, width, st);
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
// and o's elements a copy and `types` their type codes (see Params).
// variant:
//   0 = simt, float32 FMA: float32 at any D (width 32, 64 or 128: the
//       output columns a block computes, D beyond it split over the grid),
//       16-bit types at D > 256 (width 128), and (PerTensor, width 32, 64
//       or 128) any other types: a float8 tensor or a mix with float32,
//       or the tf32 sets (flash_tf32.cu) off its route; any strides;
//   1 = mma.sync: q, k, v of one compute type (`compute_code`: one
//       16-bit type, or float8 beside it or alone) and o of q's, D <= width
//       (32, 64, 96, 112, 128, 160, 192 or 256), any strides;
//   2 = TMA + wgmma: the same types, D % 8 == 0 and D <= width (64, 128
//       or 256), column stride 1, 16-byte aligned starts and other strides
//       in each tensor's own bytes (what the TMA and the 16- and 8-byte
//       stores take; the caller checks).
// B*H may be any int; Sq at most 65535 query tiles of 64 (128 for wgmma).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments no kernel takes.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      const int64_t* strides, const int* vecs,
                                      int causal, int window, float scale,
                                      const int* types, int variant,
                                      int width, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      window < 0 || D < 1 || variant < 0 || variant > 2 ||
      (int64_t)B * H > 0x7fffffff || (Sq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  bool one_type = true;
  for (int i = 0; i < 4; ++i) {
    if (types[i] < 0 || types[i] > 7) return (int)cudaErrorInvalidValue;
    one_type = one_type && types[i] == types[0];
  }
  const int64_t* s = strides;
  const Params p{q,       k,        v,        o,        B,        H,
                 Hkv,     Sq,       Sk,       D,        causal ? 1 : 0,
                 window,  scale,    s[0],     s[1],     s[2],     s[3],
                 s[4],    s[5],     s[6],     s[7],     s[8],     s[9],
                 s[10],   s[11],    s[12],    s[13],    s[14],    s[15],
                 vecs[0], vecs[1],  vecs[2],  vecs[3],  types[0], types[1],
                 types[2], types[3]};
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
  if (variant == 0) return launch_per_tensor(p, width, st);
  // the tensor cores, some input decoded from float8: where the types
  // have a 16-bit compute type and the output is q's
  const int c = compute_code(types);
  if (c < 1 || c > 2 || types[3] != types[0])
    return (int)cudaErrorInvalidValue;
  return c == 1 ? launch_tc<bf16, true>(p, variant, width, st)
                : launch_tc<f16, true>(p, variant, width, st);
}
