// Flash attention forward on Hopper's tf32 tensor cores (sm_90a), for the
// sets of q, k and v types that have no 16-bit compute type and no
// float32 operand: bfloat16 beside float16, or float16 beside
// float8_e8m0fnu, with or without other float8 formats (`compute_code`
// 3).  Replaces, for these sets, the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py, which casts each operand to
// float32, takes its products in float32 and rounds the output to q's
// type; the function is flash_attention.cu's (causal aligned bottom-right,
// a window, GQA by index, each tensor through its strides).
//
// Why tf32: it keeps float32's 8-bit exponent and a 10-bit mantissa, so
// every value of bfloat16, float16 and the float8 formats is one of its
// values (a float16 subnormal is a tf32 normal, e8m0fnu's 2^-127 a
// subnormal); the product of two such values has at most 11 x 11
// significant bits and is exact in float32.  So the tensor cores at the
// tf32 rate compute what the Pallas kernel computes but for the order of
// the sums and P, which is rounded to tf32 for the P V product (`cvt.rna`,
// to nearest, ties away from zero: a relative error of at most 2^-11 a
// weight, as float16's rounding of P on the 16-bit routes; the row sums
// take P unrounded).
//
// Bound: operations.  4 D flops a kept (query, key) pair at the tf32 rate
// (494 TFLOP/s dense on an H100 SXM): at B=2, H=32, S=4096, D=128, causal
// 2.75e11 flop, 0.557 ms, against 4.10 ms on the float32 FMA units where
// the PerTensor simt kernel runs these sets off this route.
//
// Design (FlashAttention-3's shape, as flash_fwd_wgmma, with what tf32
// changes):
//   - a block of 3 warpgroups owns 128 query rows; the producer warpgroup
//     (56 registers) brings every K and V tile raw by TMA, in its own type
//     (16-bit or UINT8 tensor maps), into two raw stages under mbarriers,
//     and its 128 threads decode each into a 4-byte tf32 tile of a
//     two-stage ring in the 128-byte swizzle, fence the async proxy and
//     arrive; two consumer warpgroups (224 registers) of 64 rows each run
//     wgmma m64nNk8 tf32 on them;
//   - tf32 wgmma reads both shared-memory operands K-major only (no
//     transpose bit), so the producer writes V transposed (V^T, keys
//     contiguous: `decode_v` reads the raw tile through ldmatrix.trans, so
//     the transpose costs only the address pattern); and the f32
//     accumulator holds keys 2t and 2t + 1 of each 8 where the tf32 A
//     fragment wants t and t + 4, so within each group of 8 keys V^T
//     stores key e at (e >> 1) + 4 (e & 1): P goes from the S registers
//     into P V with no shuffle;
//   - shared memory at W = 128 with 64-key tiles: two tf32 stages of K and
//     V^T (128 KB) and two raw stages (64 KB); Q as a tf32 tile (64 KB)
//     does not fit beside them, so each consumer holds its 64 rows of Q as
//     the register A operand of Q K^T (64 registers a thread at D = 128),
//     loaded and decoded once a block.  ptxas then spills 608 bytes and
//     serialises the wgmma (C7512), but Q as a shared-memory tile with one
//     raw stage measured slower (each consumer reads Q's 32 KB again
//     every tile, and shared memory is this kernel's tightest resource:
//     tf32 doubles the bytes of each decoded tile).  At W = 256 neither
//     fits (Q 128 registers beside an accumulator of 128), so the route
//     ends at D = 128 and D in (128, 256] stays on the PerTensor simt
//     kernel;
//   - the output is written from the accumulator registers in q's type
//     (pairs of columns, `encode_f8x2` for a float8 q).
#include "flash_common.cuh"

namespace {

namespace tf {
constexpr int kBQ = 128;        // query rows a block: 2 consumers x 64
constexpr int kBK = 64;         // keys a tile
constexpr int kThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kStages = 2;      // depth of the tf32 ring and of the raw one
constexpr int kRow = 128;       // bytes of a swizzled row: 32 tf32
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
// bytes of a tf32 K tile [key][W] or V^T tile [W][key]
template <int W>
__host__ __device__ constexpr int tile_bytes() {
  return kBK * W * 4;
}
// bytes of a raw K or V tile as the TMA brings it (room for 16-bit)
template <int W>
__host__ __device__ constexpr int raw_bytes() {
  return kBK * W * 2;
}
template <int W>
constexpr size_t smem_bytes() {
  // 1024 bytes of slack to align the swizzled tiles, the K and V^T rings,
  // the raw stages of K and V, and 10 mbarriers
  return 1024 + 2 * kStages * tile_bytes<W>() + 2 * kStages * raw_bytes<W>() +
         128;
}
}  // namespace tf

// Calls f(std::integral_constant<int, CODE>) for the type code of an
// operand of this route (1-7: 16-bit or float8), a branch uniform over
// the warpgroup.
template <typename F>
__device__ __forceinline__ void with_tc_code(int code, F&& f) {
  switch (code) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    default: f(std::integral_constant<int, 7>{});
  }
}

// float32 -> tf32, to nearest with ties away from zero: the bits of a
// float32 whose low 13 mantissa bits are zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Decodes a raw K tile of type CODE (box c of 64 columns at raw + c kBK 64
// EB, rows of 64 EB bytes, no swizzle) into the tf32 tile `dst`: panel j
// (columns 32 j ... 32 j + 31) at dst + j kBK kRow, 128 bytes a row,
// 16-byte chunk u of row r at 16 (u ^ (r & 7)), the swizzle the wgmma
// descriptors read.  A thread takes 4 columns of a row at a time,
// neighbours on neighbouring columns: a half warp reads 128 bytes in a
// row of raw, a quarter warp writes the 8 chunks of one swizzled row.
// Columns past D hold TMA's zeros, decoded (e8m0fnu's byte 0 as 2^-127):
// Q is 0 there, so they add nothing.
template <int W, int CODE>
__device__ __forceinline__ void decode_k(unsigned char* dst,
                                         const unsigned char* raw, int tid) {
  using namespace tf;
  constexpr int EB = kBytes<CODE>;
#pragma unroll 4
  for (int i = tid; i < (W / 64) * kBK * 16; i += 128) {
    const int c = i / (kBK * 16), r = (i / 16) % kBK, g = i % 16;
    const unsigned char* x = raw + (c * kBK + r) * 64 * EB + g * 4 * EB;
    float f[4];
    if constexpr (EB == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(x);
      dec_word<CODE>(u.x, f);
      dec_word<CODE>(u.y, f + 2);
    } else {
      dec_word<CODE>(*reinterpret_cast<const uint32_t*>(x), f);
    }
    const int col = 64 * c + 4 * g;
    *reinterpret_cast<float4*>(dst + (col >> 5) * kBK * kRow + r * kRow +
                               ((((col & 31) >> 2) ^ (r & 7)) << 4)) =
        make_float4(f[0], f[1], f[2], f[3]);
  }
}

// Decodes a raw V tile of type CODE (box c of 64 columns at raw + c kBK 64
// EB, swizzled by the TMA: 128-byte rows for 16-bit, 16-byte chunk u of
// row r at 16 (u ^ (r & 7)); 64-byte rows for float8, chunk u at
// 16 (u ^ ((r >> 1) & 3))) into V^T in tf32, the B operand of P V: row d
// of panel j (keys 32 j ... 32 j + 31) at dst + j W kRow + d kRow, in the
// 128-byte swizzle; within each group of 8 keys, key e at position
// (e >> 1) + 4 (e & 1), where the thread holding P's keys 2t and 2t + 1
// puts them as columns t and t + 4 of the A fragment.  ldmatrix.trans
// reads 8 x 8 blocks of 16-bit words (16-bit elements, or float8 pairs)
// transposed, 8 keys on 8 bank groups of the swizzle; thread (g, t) gets
// keys 2t and 2t + 1 of column g (16-bit) or of columns 2g, 2g + 1
// (float8), and its 4-byte stores fall, a warp's 32, on 32 banks (for
// float8 the threads g >= 4 store their odd column first).
template <int W, int CODE>
__device__ __forceinline__ void decode_v(unsigned char* dst,
                                         const unsigned char* raw, int tid) {
  using namespace tf;
  constexpr int EB = kBytes<CODE>;
  constexpr int BC = 16 / EB;              // columns a block spans
  constexpr int CB = W / BC;               // column blocks of a key group
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int x4 = warp; x4 < (kBK / 8) * CB / 4; x4 += 4) {
    // 4 blocks: key group kg8, column blocks cb0 ... cb0 + 3; this lane
    // gives the address of row lane % 8 of block lane / 8
    const int kg8 = x4 / (CB / 4), cb0 = (x4 % (CB / 4)) * 4;
    const int key = 8 * kg8 + (lane & 7), col = (cb0 + (lane >> 3)) * BC;
    const int u = ((col & 63) * EB) >> 4;
    const int su = EB == 2 ? u ^ (key & 7) : u ^ ((key >> 1) & 3);
    uint32_t w[4];
    ldsm_x4_t(smem_u32(raw + (col >> 6) * kBK * 64 * EB + key * 64 * EB +
                       (su << 4)),
              w);
    unsigned char* panel = dst + (kg8 >> 2) * W * kRow;
    const int ce = 2 * (kg8 & 3), co = ce + 1;  // chunks of keys 2t, 2t + 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c0 = (cb0 + i) * BC;
      if constexpr (EB == 2) {
        float f[2];
        dec_word<CODE>(w[i], f);
        const int d = c0 + g;
        unsigned char* row = panel + d * kRow + 4 * t;
        *reinterpret_cast<float*>(row + ((ce ^ (d & 7)) << 4)) = f[0];
        *reinterpret_cast<float*>(row + ((co ^ (d & 7)) << 4)) = f[1];
      } else {
        // bytes: (key 2t, col 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1,
        // 2g + 1)
        float f[4];
        dec_word<CODE>(w[i], f);
        const bool odd = g >= 4;
        const int d0 = c0 + 2 * g + odd, d1 = c0 + 2 * g + !odd;
        unsigned char* r0 = panel + d0 * kRow + 4 * t;
        unsigned char* r1 = panel + d1 * kRow + 4 * t;
        *reinterpret_cast<float*>(r0 + ((ce ^ (d0 & 7)) << 4)) =
            odd ? f[1] : f[0];
        *reinterpret_cast<float*>(r0 + ((co ^ (d0 & 7)) << 4)) =
            odd ? f[3] : f[2];
        *reinterpret_cast<float*>(r1 + ((ce ^ (d1 & 7)) << 4)) =
            odd ? f[0] : f[1];
        *reinterpret_cast<float*>(r1 + ((co ^ (d1 & 7)) << 4)) =
            odd ? f[2] : f[3];
      }
    }
  }
}

// D (64 x N, f32) (+)= A (64 x 8 tf32, registers) B (N x 8 tf32)^T, B in
// shared memory K-major; `accumulate` = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" FLASH_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : FLASH_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" FLASH_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : FLASH_F64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  if constexpr (N == 64) wgmma_tf32_n64(d, a, b, accumulate);
  else wgmma_tf32_n128(d, a, b, accumulate);
}

// The bits of the element of type CODE at p, in the low bytes.
template <int CODE>
__device__ __forceinline__ uint32_t load_bits(const unsigned char* p) {
  if constexpr (kBytes<CODE> == 2) return *reinterpret_cast<const uint16_t*>(p);
  else return *p;
}

// Two float32 outputs, columns c and c + 1 of a row, stored at p in type
// CODE as the reference rounds (bfloat16 or float16 pairs, or two float8
// bytes).
template <int CODE>
__device__ __forceinline__ void store_pair(unsigned char* p, float lo,
                                           float hi) {
  if constexpr (CODE == 1) *reinterpret_cast<uint32_t*>(p) = pack<bf16>(lo, hi);
  else if constexpr (CODE == 2) *reinterpret_cast<uint32_t*>(p) = pack<f16>(lo, hi);
  else *reinterpret_cast<uint16_t*>(p) = encode_f8x2<CODE>(lo, hi);
}

// W: the width, 64 (D <= 64) or 128 (D <= 128), D % 8 == 0; q, k, v of
// compute code 3 (tf32), o of q's type; column strides 1, rows on 16
// bytes (the TMA's layout).  The columns past D are TMA's zeros in K and
// V, zeros in Q's registers, and not stored.
template <int W>
__global__ void __launch_bounds__(tf::kThreads, 1)
    flash_fwd_tf32(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using namespace tf;
  constexpr int kTile = tile_bytes<W>(), kRaw = raw_bytes<W>();
  constexpr int kKPanel = kBK * kRow;   // bytes of a 32-column K panel
  constexpr int kVPanel = W * kRow;     // bytes of a 32-key V^T panel
  const int D = p.D;
  const int kb = code_bytes(p.k_type), vb = code_bytes(p.v_type);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Ks =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [stage]
  unsigned char* Vs = Ks + kStages * kTile;                      // [stage]
  unsigned char* KR = Vs + kStages * kTile;                  // [raw stage]
  unsigned char* VR = KR + kStages * kRaw;                   // [raw stage]
  uint64_t* k_full = reinterpret_cast<uint64_t*>(VR + kStages * kRaw);
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  uint64_t* rk_full = empty + kStages;
  uint64_t* rv_full = rk_full + kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // last tile first
  const int off = p.Sk - p.Sq;
  int kbeg, kend;
  kv_range(p, q0 + off, min(q0 + kBQ, p.Sq) - 1 + off, kbeg, kend);
  const int t_first = kbeg / kBK;
  const int n_tiles = kend > kbeg ? (kend - 1) / kBK + 1 - t_first : 0;

  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 128);  // the producer's threads, once decoded
      mbar_init(&v_full[s], 128);
      mbar_init(&empty[s], 8);     // one arrival per consumer warp
      mbar_init(&rk_full[s], 1);   // the TMA's bytes
      mbar_init(&rv_full[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: thread 0 issues the raw loads of a tile (its boxes'
    // whole bytes, columns past D included), the 128 threads decode it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    auto issue_raw = [&](int it) {
      const int r = it % kStages, k0 = (t_first + it) * kBK;
      mbar_expect_tx(&rk_full[r], (W / 64) * kBK * 64 * kb);
      for (int c = 0; c < W / 64; ++c)
        tma_load(KR + r * kRaw + c * kBK * 64 * kb, &tk, &rk_full[r], 64 * c,
                 k0, hk, b);
      mbar_expect_tx(&rv_full[r], (W / 64) * kBK * 64 * vb);
      for (int c = 0; c < W / 64; ++c)
        tma_load(VR + r * kRaw + c * kBK * 64 * vb, &tv, &rv_full[r], 64 * c,
                 k0, hk, b);
    };
    if (tid == 0)
      for (int it = 0; it < min(kStages, n_tiles); ++it) issue_raw(it);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t use = it / kStages;
      mbar_wait(&empty[s], (use & 1) ^ 1);  // the first use passes
      mbar_wait(&rk_full[s], use & 1);
      with_tc_code(p.k_type, [&](auto cv) {
        decode_k<W, decltype(cv)::value>(Ks + s * kTile, KR + s * kRaw, tid);
      });
      fence_async_smem();
      mbar_arrive(&k_full[s]);
      mbar_wait(&rv_full[s], use & 1);
      with_tc_code(p.v_type, [&](auto cv) {
        decode_v<W, decltype(cv)::value>(Vs + s * kTile, VR + s * kRaw, tid);
      });
      fence_async_smem();
      mbar_arrive(&v_full[s]);
      // every thread has read raw stage s: thread 0 refills it
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (tid == 0 && it + kStages < n_tiles) issue_raw(it + kStages);
    }
    return;
  }

  // ---- consumer warpgroup cw: query rows q0 + 64 cw ... + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wgi - 1;
  const int g = lane >> 2, t = lane & 3;  // fragment coordinates
  const int row0 = q0 + 64 * cw + 16 * warp + g, row1 = row0 + 8;
  const int qp0 = row0 + off, qp1 = qp0 + 8;
  const int pos_lo = q0 + 64 * cw + off, pos_hi = pos_lo + 63;
  const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)
  const float kMinusInf = __int_as_float(0xff800000);

  // Q's rows row0 and row1 as the tf32 A fragments of the W / 8 k8 steps
  // (a0: row0, column t; a1: row1, t; a2: row0, t + 4; a3: row1, t + 4),
  // decoded from q's type once a block; zeros past D and Sq
  uint32_t qf[W / 8][4];
  with_tc_code(p.q_type, [&](auto cv) {
    constexpr int CODE = decltype(cv)::value;
    constexpr int EB = kBytes<CODE>;
    const unsigned char* q =
        (const unsigned char*)p.q + (b * p.q_sb + h * p.q_sh) * EB;
    auto at = [&](int row, int col) -> uint32_t {
      if (row >= p.Sq || col >= D) return 0u;
      return __float_as_uint(
          dec1<CODE>(load_bits<CODE>(q + (row * p.q_ss + col) * EB)));
    };
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) {
      qf[kk][0] = at(row0, 8 * kk + t);
      qf[kk][1] = at(row1, 8 * kk + t);
      qf[kk][2] = at(row0, 8 * kk + t + 4);
      qf[kk][3] = at(row1, 8 * kk + t + 4);
    }
  });

  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of the raw logits
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the sums

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const int k0 = (t_first + it) * kBK;
    const uint32_t k_addr = smem_u32(Ks + s * kTile);
    const uint32_t v_addr = smem_u32(Vs + s * kTile);

    // S = Q K^T (64 x kBK), Q from registers, K from the decoded tile
    float sc[kBK / 2];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk)
      wgmma_tf32_n64(sc, qf[kk],
                     smem_desc(k_addr + (kk >> 2) * kKPanel + (kk & 3) * 32,
                               16),
                     kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // the per-element mask, only where some key of the tile is masked for
    // some row of this warpgroup
    const bool edge = k0 + kBK > p.Sk ||
                      (p.causal && k0 + kBK - 1 > pos_lo) ||
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
      for (int i = 0; i < kBK / 2; ++i) {
        const int c = 8 * (i >> 2) + (i & 1);
        if (c > ((i & 2) ? hi1 : hi0) || c < ((i & 2) ? lo1 : lo0))
          sc[i] = kMinusInf;
      }
    }

    // online softmax in base 2: p = 2^(s * sl2 - m * sl2)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
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
    for (int i = 0; i < kBK / 2; ++i) {
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

    // P, rounded to tf32, as the A fragments of the k8 steps of P V: step
    // j takes keys 8j ... 8j + 7, this thread's 8j + 2t and 8j + 2t + 1 as
    // columns t and t + 4 (V^T's order)
    uint32_t pa[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      pa[j][0] = to_tf32(sc[4 * j]);
      pa[j][1] = to_tf32(sc[4 * j + 2]);
      pa[j][2] = to_tf32(sc[4 * j + 1]);
      pa[j][3] = to_tf32(sc[4 * j + 3]);
    }

    // O += P V from V^T (W rows of 64 keys); the columns past D are not
    // stored
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
      wgmma_tf32<W>(acc, pa[j],
                    smem_desc(v_addr + (j >> 2) * kVPanel + (j & 3) * 32, 16),
                    1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage may be refilled
  }

  // epilogue: normalise and store pairs of columns from the registers in
  // q's type, the rounding compiled once a type
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, sh);
    l1 += __shfl_xor_sync(kFull, l1, sh);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  with_tc_code(p.o_type, [&](auto cv) {
    constexpr int CODE = decltype(cv)::value;
    constexpr int EB = kBytes<CODE>;
    unsigned char* o = (unsigned char*)p.o + (b * p.o_sb + h * p.o_sh) * EB;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (8 * j >= D) continue;
      const int col = 8 * j + 2 * t;
      if (row0 < p.Sq)
        store_pair<CODE>(o + (row0 * p.o_ss + col) * EB, acc[4 * j] * inv0,
                         acc[4 * j + 1] * inv0);
      if (row1 < p.Sq)
        store_pair<CODE>(o + (row1 * p.o_ss + col) * EB,
                         acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  });
}

template <int W>
int launch(const Params& p, cudaStream_t stream) {
  using namespace tf;
  static bool attr = false;
  const int e = set_smem(flash_fwd_tf32<W>, attr, smem_bytes<W>());
  if (e) return e;
  // K raw, unswizzled; V in the swizzle that makes ldmatrix.trans
  // conflict-free: 128 bytes for 16-bit rows, 64 for float8 rows
  CUtensorMap tk, tv;
  if (!encode(&tk, p.k, p.k_type, p.D, p.Sk, p.Hkv, p.B, p.k_sb, p.k_sh,
              p.k_ss, kBK, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&tv, p.v, p.v_type, p.D, p.Sk, p.Hkv, p.B, p.v_sb, p.v_sh,
              p.v_ss, kBK,
              code_bytes(p.v_type) == 2 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd_tf32<W><<<grid, tf::kThreads, smem_bytes<W>(), stream>>>(tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,D), k and v (B,Hkv,Sk,D), o (B,H,Sq,D), each addressed by its
// element strides (batch, head, row, column; `strides` holds 16 of them in
// the order q, k, v, o), on the current device; `types` the type codes of
// q, k, v and o (flash_common.cuh's Params), which must have compute code
// 3 (tf32), o of q's type; D % 8 == 0, D <= width (64 or 128); column
// strides 1, 16-byte aligned starts and other strides in each tensor's own
// bytes (the TMA's layout; the caller checks).  B*H may be any int; Sq at
// most 65535 query tiles of 128.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int flash_tf32_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Hkv, int Sq,
                                 int Sk, int D, const int64_t* strides,
                                 int causal, int window, float scale,
                                 const int* types, int width, void* stream) {
  const int64_t* s = strides;
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      window < 0 || D < 1 || D % 8 != 0 || D > width ||
      (width != 64 && width != 128) || (int64_t)B * H > 0x7fffffff ||
      (Sq + tf::kBQ - 1) / tf::kBQ > 65535 || s[3] != 1 || s[7] != 1 ||
      s[11] != 1 || s[15] != 1)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (types[i] < 0 || types[i] > 7) return (int)cudaErrorInvalidValue;
  if (compute_code(types) != kTf32 || types[3] != types[0])
    return (int)cudaErrorInvalidValue;
  const Params p{q,     k,     v,     o,     B,     H,     Hkv,
                 Sq,    Sk,    D,     causal ? 1 : 0,      window,
                 scale, s[0],  s[1],  s[2],  s[3],  s[4],  s[5],
                 s[6],  s[7],  s[8],  s[9],  s[10], s[11], s[12],
                 s[13], s[14], s[15], 0,     0,     0,     0,
                 types[0], types[1], types[2], types[3]};
  cudaStream_t st = (cudaStream_t)stream;
  return width == 64 ? launch<64>(p, st) : launch<128>(p, st);
}
