// The chunked SSD (Mamba2's state-space scan) of a prefill on an NVIDIA
// Hopper card (sm_90a).
//
// Replaces no Pallas kernel: the reference computes the SSD in plain JAX
// (src/repro/models/zamba2.py `_ssd_chunked`), and so did the port
// (src/repro_torch/models/zamba2.py `_ssd_chunked`), which built every
// (B, nc, Q, Q, H) intra-chunk term in device memory in float32: at
// zamba2-7b's S = 4096, Q = 256, H = 112 four tensors of 470 MB a block.
// This computes the same function without them, with the same rounding
// points: xh (B, S, H, P) bf16, Bm and Cm (B, S, N) bf16, da and dt
// (B, S, H) float32 -> y (B, S, H, P) float32 and the final state
// (B, H, N, P) float32, for P = 64 and N = 64 (zamba2) or 128 (Granite
// 4.0-H), any B and H, and a chunk Q of 16, 32, 64, 128 or 256 dividing S.
// Every kernel is a template on N.  Per chunk c and head h, with j <= i
// positions of the chunk:
//
//   seg_i = da_0 + ... + da_i                         (float32, in order)
//   att_ij = bf16((C_i . B_j) * exp(seg_i - seg_j) * dt_j)
//   y_i = sum_j att_ij x_j + exp(seg_i) (C_i . S_{c-1})
//   st_c = sum_j B_j^T bf16(exp(seg_last - seg_j) * dt_j) x_j
//   S_c = exp(seg_last) * S_{c-1} + st_c              (S_{-1} = 0)
//
// Rounding: the cumsum runs in torch's order (one sum a column, first to
// last), each product of floats rounds where the plain version's does
// (__fmul_rn, __fadd_rn: no fused multiply-add the plain version lacks),
// and att and the state's weights round to bf16 where it rounds them.
// The products whose operands are bf16 there (C . B, att x) run on the
// tensor cores in bf16 with float32 sums, which are exact products summed
// in float32 as the plain version's float32 einsums sum them (in another
// order).  The operands it holds in float32 keep float32 accuracy: B_j w_j
// (w in bf16) is exact in float32 with 16 significant bits, so it is two
// bf16 pieces whose sum is exact; the carried state S_{c-1} is three.
// Each piece's product is exact, so no bf16 or tf32 rounding enters that
// the plain version does not make.
//
// Bound, at S = 4096, H = 112 (one zamba2-7b block): 183 MB of inputs and
// outputs read or written once at 3.35 TB/s (55 us; y in float32 is 117
// MB of it), 15 GFLOP of products at the bf16 peak (15 us) and 59 M
// exponentials of the lower triangles (14 us): bytes.  Four kernels on the
// current stream, each filling the card:
//
//   ssd_prep (grid H/32 x nc x B, a lane a head): the per-position scalars
//     of 32 heads of a chunk, read row by row (the heads side by side):
//     seg by one chain of adds a head in torch's order, and w_j; seg, dt
//     and w written head by head, so the other kernels read a head's
//     positions side by side (read head by head from (B, S, H), they cost
//     the states kernel a quarter of its time);
//   ssd_states (grid H x nc x B, N / 16 warps): st_c by mma.sync m16n8k16,
//     B w in two pieces, B's and x's rows in two copy groups so that the
//     first half's products start while the second half lands;
//   ssd_scan (grid 16 x H x B): S_c over the chunks in order, an element
//     a thread; st_c is overwritten by S_{c-1}, the state before chunk c
//     (run instead by the last of a head's states blocks to finish, the
//     scans queued at the end and took longer than this kernel);
//   ssd_output (grid H x nc x B, Q / 32 warps, two blocks an SM at N = 64,
//     one at N = 128): C's fragments in registers, then S_{c-1} in three
//     bf16 pieces where C was; each warp owns query tiles t and T - 1 - t
//     of 16 rows (equal
//     work) and walks the key tiles j <= i (none above the diagonal is
//     computed or exponentiated): C . B and att in registers, att x and
//     the pieces' products accumulated on the tensor cores.  Its first
//     tile needs only the first half of B's and x's rows, the first copy
//     group.  Its largest cost in instructions is expf, which it keeps:
//     a cheaper exponential would move att across bf16 rounding
//     boundaries that the plain version's expf does not.
//
// Shared memory at Q = 256: B's and C's tiles are N wide, x's P wide.
// ssd_states holds B and x (N = 64: 72.7 KB; N = 128: 107.5 KB, two
// blocks an SM either way); ssd_output holds C (or the state's three
// pieces, 3 x N rows of P), B, x, seg and dt: 110 KB at N = 64 and 174 KB
// at N = 128, under the 227 KB a block may take.
#include "flash_common.cuh"

namespace {

constexpr int kP = 64;                 // head dim (ssm_head_dim)
constexpr int kMaxQ = 256;
constexpr int kScanThreads = 256;
constexpr int kPrepHeads = 32;         // ssd_prep: a lane a head
constexpr int kPrepWarps = 8;

struct SsdParams {
  const bf16* x;
  const bf16* bm;
  const bf16* cm;
  const float* da;
  const float* dt;
  float* y;      // (B, S, H, P), dense
  float* state;  // (B, H, N, P), dense
  // scratch, each (B, H, S) dense (a head's positions side by side): the
  // chunks' cumsums seg, dt, and the state's weights w (bf16 values)
  float* seg;
  float* dth;
  float* w;
  float* st;     // (B, nc, H, N, P), dense: st_c, then S_{c-1}
  // element strides: x's batch, row, head; Bm's and Cm's batch, row; da's
  // and dt's batch, row, head (the last dimension of x, Bm, Cm has
  // stride 1)
  int64_t x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, a_sb, a_ss, a_sh, t_sb,
      t_ss, t_sh;
  int B, S, H, Q;
};

// bytes a tile row of W bf16: the row and 16 of padding (ldmatrix reads
// 8 rows without a bank conflict)
__host__ __device__ constexpr int pitch(int W) { return 2 * W + 16; }

// the byte offset of 16-byte piece `chunk` of row r in a tile W wide
template <int W>
__device__ __forceinline__ int at(int r, int chunk) {
  return r * pitch(W) + (chunk << 4);
}

// rows x W bf16 (row r at src + r * ss) into the tile `dst` by cp.async
// of 16 bytes
template <int W>
__device__ __forceinline__ void load_rows(unsigned char* dst, const bf16* src,
                                          int64_t ss, int rows, int tid,
                                          int threads) {
  constexpr int kPer = W / 8;
  for (int i = tid; i < rows * kPer; i += threads) {
    const int r = i / kPer, ch = i % kPer;
    cp_async<16>(smem_u32(dst + at<W>(r, ch)), src + r * ss + ch * 8, true);
  }
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
// the bf16 nearest x, and x less it (exact)
__device__ __forceinline__ bf16 split(float x, float& rest) {
  const bf16 h = __float2bfloat16_rn(x);
  rest = __fsub_rn(x, __bfloat162float(h));
  return h;
}
__device__ __forceinline__ uint32_t pair(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Per chunk and 32 heads, the scalars of each position: da and dt read
// row by row (a row's heads side by side), the cumsum seg in torch's order
// (one chain of adds a head, first to last: its cumsum along a dimension
// not the last), w_j = bf16(exp(seg_last - seg_j) dt_j), and seg, dt, w
// written head by head for the other kernels
__global__ void __launch_bounds__(kPrepHeads * kPrepWarps)
    ssd_prep(const SsdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = p.Q, h0 = blockIdx.x * kPrepHeads, c = blockIdx.y,
            b = blockIdx.z;
  constexpr int kLd = kPrepHeads + 1;  // a row's pitch: no bank conflict
  float* da = reinterpret_cast<float*>(smem);  // [Q][kLd], then seg
  float* dt = da + Q * kLd;                    // [Q][kLd]
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int64_t s0 = (int64_t)c * Q;
  {  // 16 rows' loads in flight a lane
    const int h = h0 + lane;
    const bool ok = h < p.H;
    const float* ga = p.da + b * p.a_sb + s0 * p.a_ss + h * p.a_sh;
    const float* gt = p.dt + b * p.t_sb + s0 * p.t_ss + h * p.t_sh;
    for (int r0 = wp; r0 < Q; r0 += 16 * kPrepWarps) {
      float a[16], d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int r = r0 + k * kPrepWarps;
        a[k] = ok && r < Q ? ga[r * p.a_ss] : 0.f;
        d[k] = ok && r < Q ? gt[r * p.t_ss] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int r = r0 + k * kPrepWarps;
        if (r < Q) {
          da[r * kLd + lane] = a[k];
          dt[r * kLd + lane] = d[k];
        }
      }
    }
  }
  __syncthreads();
  if (wp == 0) {  // the chain, the next 8 values read while 8 are summed
    float acc = 0.f, nxt[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) nxt[k] = da[k * kLd + lane];
    for (int r = 0; r < Q; r += 8) {
      float cur[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cur[k] = nxt[k];
        if (r + 8 < Q) nxt[k] = da[(r + 8 + k) * kLd + lane];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        da[(r + k) * kLd + lane] = acc = __fadd_rn(acc, cur[k]);
    }
  }
  __syncthreads();
  for (int k = wp; k < kPrepHeads && h0 + k < p.H; k += kPrepWarps) {
    const int64_t o = ((int64_t)b * p.H + h0 + k) * p.S + s0;
    const float last = da[(Q - 1) * kLd + k];
    for (int r = lane; r < Q; r += 32) {
      const float sj = da[r * kLd + k], dj = dt[r * kLd + k];
      p.seg[o + r] = sj;
      p.dth[o + r] = dj;
      p.w[o + r] = __bfloat162float(__float2bfloat16_rn(
          __fmul_rn(expf(__fsub_rn(last, sj)), dj)));
    }
  }
}

// ssd_states' threads: N / 16 warps, 16 state rows each
template <int N>
__host__ __device__ constexpr int states_threads() { return 2 * N; }

template <int N>
__global__ void __launch_bounds__(states_threads<N>())
    ssd_states(const SsdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kThreads = states_threads<N>();
  const int Q = p.Q, h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  unsigned char* Bs = smem;                  // [Q][N] bf16, B_j
  unsigned char* Xs = Bs + Q * pitch(N);     // [Q][P] bf16, x_j of head h
  float* w = reinterpret_cast<float*>(Xs + Q * pitch(kP));  // [Q] w_j
  const int tid = threadIdx.x;
  const int64_t s0 = (int64_t)c * Q;

  // two copy groups, rows [0, Q/2) and [Q/2, Q): the first half's products
  // start while the second lands
  const bf16* bsrc = p.bm + b * p.b_sb + s0 * p.b_ss;
  const bf16* xsrc = p.x + b * p.x_sb + s0 * p.x_ss + h * p.x_sh;
  for (int half = 0; half < 2; ++half) {
    const int r0 = half * Q / 2;
    load_rows<N>(Bs + r0 * pitch(N), bsrc + r0 * p.b_ss, p.b_ss, Q / 2, tid,
                 kThreads);
    load_rows<kP>(Xs + r0 * pitch(kP), xsrc + r0 * p.x_ss, p.x_ss, Q / 2,
                  tid, kThreads);
    cp_commit();
  }
  const float* wg = p.w + ((int64_t)b * p.H + h) * p.S + s0;
  for (int j = tid; j < Q; j += kThreads) w[j] = wg[j];
  cp_wait<1>();
  __syncthreads();

  // st[n][p] = sum_j (B_jn w_j) x_jp: warp wp owns n in [16 wp, 16 wp + 16)
  const int lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const uint32_t bs = smem_u32(Bs), xs = smem_u32(Xs);
  for (int ks = 0; ks < Q / 16; ++ks) {
    if (ks == Q / 32) {  // the second half's rows
      cp_wait<0>();
      __syncthreads();
    }
    // A (n x j) from B stored [j][n]: transposed 8x8 matrices
    uint32_t a[4], hi[4], lo[4];
    ldsm_x4_t(bs + at<N>(16 * ks + lr + ((lm >> 1) << 3), 2 * wp + (lm & 1)),
              a);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 16 * ks + 2 * t + ((r >> 1) << 3);
      float r0, r1;
      const bf16 h0 = split(__fmul_rn(bf16_lo(a[r]), w[j]), r0);
      const bf16 h1 = split(__fmul_rn(bf16_hi(a[r]), w[j + 1]), r1);
      hi[r] = pair(h0, h1);
      lo[r] = pair(__float2bfloat16_rn(r0), __float2bfloat16_rn(r1));
    }
#pragma unroll
    for (int dp = 0; dp < kP / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_t(
          xs + at<kP>(16 * ks + lr + ((lm & 1) << 3), 2 * dp + (lm >> 1)),
          bf);
      mma_bf16(acc[2 * dp], hi, bf[0], bf[1]);
      mma_bf16(acc[2 * dp], lo, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], hi, bf[2], bf[3]);
      mma_bf16(acc[2 * dp + 1], lo, bf[2], bf[3]);
    }
  }
  float* out = p.st + (((int64_t)b * nc + c) * p.H + h) * (N * kP);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 16 * wp + g, col = 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(out + n * kP + col) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (n + 8) * kP + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// S_c = exp(seg_last,c) * S_{c-1} + st_c over the chunks in order, an
// element of (N, P) a thread; st_c becomes S_{c-1}
template <int N>
__global__ void __launch_bounds__(kScanThreads) ssd_scan(const SsdParams p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * kScanThreads + threadIdx.x;
  const int nc = p.S / p.Q;
  const int64_t step = (int64_t)p.H * N * kP;
  float* st = p.st + ((int64_t)b * nc * p.H + h) * (N * kP) + e;
  const float* last = p.seg + ((int64_t)b * p.H + h) * p.S + p.Q - 1;
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 8) {  // 8 chunks' loads in flight
    float add[8], gl[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < nc) {
        add[k] = st[(c0 + k) * step];
        gl[k] = expf(last[(int64_t)(c0 + k) * p.Q]);
      }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < nc) {
        st[(c0 + k) * step] = s;
        s = __fadd_rn(__fmul_rn(gl[k], s), add[k]);
      }
  }
  p.state[((int64_t)b * p.H + h) * (N * kP) + e] = s;
}

// bytes of ssd_output's C region at chunk Q: C's tile (Q rows of N), where
// the state's three pieces go after (3 x N rows of P)
template <int N>
__host__ __device__ constexpr int output_c_bytes(int Q) {
  return Q * pitch(N) > 3 * N * pitch(kP) ? Q * pitch(N)
                                          : 3 * N * pitch(kP);
}

// bytes of ssd_output's shared memory: the C region, B's and x's tiles,
// seg and dt
template <int N>
__host__ __device__ constexpr int output_smem(int Q) {
  return output_c_bytes<N>(Q) + Q * pitch(N) + Q * pitch(kP) + 2 * Q * 4;
}

template <int N>
__global__ void __launch_bounds__(kMaxQ, N == 64 ? 2 : 1)
    ssd_output(const SsdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = p.Q, T = Q / 16, h = blockIdx.x, c = blockIdx.y,
            b = blockIdx.z;
  const int nc = gridDim.y;
  unsigned char* Cs = smem;  // [Q][N] C_i; then [3][N][P] S_{c-1}
  unsigned char* Bs = Cs + output_c_bytes<N>(Q);
  unsigned char* Xs = Bs + Q * pitch(N);
  float* seg = reinterpret_cast<float*>(Xs + Q * pitch(kP));
  float* dt = seg + Q;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int64_t s0 = (int64_t)c * Q;

  // S_{c-1}'s first kPre x threads float4 into registers, in flight with
  // the copies; two copy groups: C and the first half of B's and x's rows
  // (all a warp's first query tile needs), then the second half
  constexpr int kPre = 4;
  const float4* prev = reinterpret_cast<const float4*>(
      p.st + (((int64_t)b * nc + c) * p.H + h) * (N * kP));
  float4 pre[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k)
    if (c > 0 && tid + k * threads < N * kP / 4) pre[k] = prev[tid + k * threads];
  const bf16* bsrc = p.bm + b * p.b_sb + s0 * p.b_ss;
  const bf16* xsrc = p.x + b * p.x_sb + s0 * p.x_ss + h * p.x_sh;
  load_rows<N>(Cs, p.cm + b * p.c_sb + s0 * p.c_ss, p.c_ss, Q, tid, threads);
  for (int half = 0; half < 2; ++half) {
    const int r0 = half * Q / 2;
    load_rows<N>(Bs + r0 * pitch(N), bsrc + r0 * p.b_ss, p.b_ss, Q / 2, tid,
                 threads);
    load_rows<kP>(Xs + r0 * pitch(kP), xsrc + r0 * p.x_ss, p.x_ss, Q / 2,
                  tid, threads);
    cp_commit();
  }
  {
    const int64_t o = ((int64_t)b * p.H + h) * p.S + s0;
    for (int j = tid; j < Q; j += threads) {
      seg[j] = p.seg[o + j];
      dt[j] = p.dth[o + j];
    }
  }
  cp_wait<1>();
  __syncthreads();

  const int lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int ntiles = T == 1 ? 1 : 2;
  // the A fragments of C for this warp's query tiles wp and T - 1 - wp
  uint32_t cf[2][N / 16][4];
  const uint32_t cs = smem_u32(Cs), bs = smem_u32(Bs), xs = smem_u32(Xs);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k < ntiles) {
      const int ti = k == 0 ? wp : T - 1 - wp;
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks)
        ldsm_x4(cs + at<N>(16 * ti + lr + ((lm & 1) << 3), 2 * ks + (lm >> 1)),
                cf[k][ks]);
    }
  }
  if (c > 0) {  // S_{c-1} in three bf16 pieces, over C's tile
    __syncthreads();
    auto pieces = [&](int i, const float4 v) {
      const int n = (4 * i) / kP, col = (4 * i) % kP;
      const float f[4] = {v.x, v.y, v.z, v.w};
      bf16 pc[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float r1, r2;
        pc[0][e] = split(f[e], r1);
        pc[1][e] = split(r1, r2);
        pc[2][e] = __float2bfloat16_rn(r2);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint2*>(Cs + k * N * pitch(kP) + at<kP>(n, 0) +
                                  col * 2) =
            make_uint2(pair(pc[k][0], pc[k][1]), pair(pc[k][2], pc[k][3]));
    };
#pragma unroll
    for (int k = 0; k < kPre; ++k)
      if (tid + k * threads < N * kP / 4) pieces(tid + k * threads, pre[k]);
    for (int i = tid + kPre * threads; i < N * kP / 4; i += threads)
      pieces(i, prev[i]);
  }
  if (c > 0 || T == 1) {  // the pieces written; one tile needs every row
    if (T == 1) cp_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k >= ntiles) break;
    if (k == 1) {  // the second half's rows
      cp_wait<0>();
      __syncthreads();
    }
    const int ti = k == 0 ? wp : T - 1 - wp;
    const int i0 = 16 * ti + g, i1 = i0 + 8;
    const float seg0 = seg[i0], seg1 = seg[i1];
    float acc[kP / 8][4];
#pragma unroll
    for (int i = 0; i < kP / 8; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int u = 0; u <= ti; ++u) {
      // C . B for keys 16 u ... 16 u + 15
      float cb[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t bf[4];
        ldsm_x4(bs + at<N>(16 * u + lr + ((lm >> 1) << 3), 2 * ks + (lm & 1)),
                bf);
        mma_bf16(cb[0], cf[k][ks], bf[0], bf[1]);
        mma_bf16(cb[1], cf[k][ks], bf[2], bf[3]);
      }
      // att = bf16(cb * exp(seg_i - seg_j) * dt_j) for j <= i, else 0
      // (the mask only on the diagonal tile)
      float att[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 16 * u + 8 * nt + 2 * t + e;
          const float sj = seg[j], dj = dt[j];
          att[nt][e] = __fmul_rn(
              __fmul_rn(cb[nt][e], expf(__fsub_rn(seg0, sj))), dj);
          att[nt][2 + e] = __fmul_rn(
              __fmul_rn(cb[nt][2 + e], expf(__fsub_rn(seg1, sj))), dj);
        }
      if (u == ti)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 16 * u + 8 * nt + 2 * t + e;
            if (j > i0) att[nt][e] = 0.f;
            if (j > i1) att[nt][2 + e] = 0.f;
          }
      uint32_t a[4];
      a[0] = pack<bf16>(att[0][0], att[0][1]);
      a[1] = pack<bf16>(att[0][2], att[0][3]);
      a[2] = pack<bf16>(att[1][0], att[1][1]);
      a[3] = pack<bf16>(att[1][2], att[1][3]);
#pragma unroll
      for (int dp = 0; dp < kP / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(
            xs + at<kP>(16 * u + lr + ((lm & 1) << 3), 2 * dp + (lm >> 1)),
            bf);
        mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    if (c > 0) {  // + exp(seg_i) (C_i . S_{c-1}), the pieces summed first
      const float e0 = expf(seg0), e1 = expf(seg1);
#pragma unroll
      for (int dp = 0; dp < kP / 16; ++dp) {
        float tmp[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks)
#pragma unroll
          for (int pc = 0; pc < 3; ++pc) {
            uint32_t bf[4];
            ldsm_x4_t(cs + pc * N * pitch(kP) +
                          at<kP>(16 * ks + lr + ((lm & 1) << 3),
                                 2 * dp + (lm >> 1)),
                      bf);
            mma_bf16(tmp[0], cf[k][ks], bf[0], bf[1]);
            mma_bf16(tmp[1], cf[k][ks], bf[2], bf[3]);
          }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[2 * dp + q][e] = __fadd_rn(
                acc[2 * dp + q][e], __fmul_rn(tmp[q][e], e < 2 ? e0 : e1));
      }
    }
    float* y0 = p.y + (((int64_t)b * p.S + s0 + i0) * p.H + h) * kP;
    float* y1 = y0 + (int64_t)8 * p.H * kP;
#pragma unroll
    for (int nt = 0; nt < kP / 8; ++nt) {
      const int col = 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(y0 + col) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(y1 + col) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

__host__ constexpr int prep_smem(int Q) {
  return 2 * Q * (kPrepHeads + 1) * 4;
}
template <int N>
__host__ constexpr int states_smem(int Q) {
  return Q * pitch(N) + Q * pitch(kP) + Q * 4;
}

bool prep_attr = false;

// The three N-dependent kernels after ssd_prep, their shared memory set
// once each
template <int N>
int launch_n(const SsdParams& p, int H, int S, int Q, int B,
             cudaStream_t s) {
  static bool states_attr = false, output_attr = false;
  int err = set_smem(ssd_states<N>, states_attr, states_smem<N>(kMaxQ));
  if (err == 0)
    err = set_smem(ssd_output<N>, output_attr, output_smem<N>(kMaxQ));
  if (err != 0) return err;
  const dim3 grid(H, S / Q, B);  // the heads of a chunk side by side
  ssd_states<N><<<grid, states_threads<N>(), states_smem<N>(Q), s>>>(p);
  ssd_scan<N><<<dim3(N * kP / kScanThreads, H, B), kScanThreads, 0, s>>>(p);
  ssd_output<N><<<grid, 32 * ((Q / 16 + 1) / 2), output_smem<N>(Q), s>>>(p);
  return 0;
}

}  // namespace

// Floats of scratch `ssd_launch` needs: seg, dt and w, then st.
extern "C" int64_t ssd_scratch_floats(int B, int S, int H, int N, int Q) {
  return 3 * (int64_t)B * H * S + (int64_t)B * (S / Q) * H * N * kP;
}

// The SSD of one block, four kernels on `stream`.  Pointers: x, Bm, Cm
// (bf16), da, dt (float32), the outputs y and state, and `scratch`
// (ssd_scratch_floats floats, 16-byte aligned); `strides`: the 13 element
// strides of SsdParams in its order.  Returns a cudaError_t (0 =
// launched).
extern "C" int ssd_launch(const void* x, const void* bm, const void* cm,
                          const void* da, const void* dt, void* y,
                          void* state, void* scratch, const int64_t* strides,
                          int B, int S, int H, int N, int P, int Q,
                          void* stream) {
  if ((N != 64 && N != 128) || P != kP || B < 1 || H < 1 || Q < 16 ||
      Q > kMaxQ ||
      (Q & (Q - 1)) != 0 || S < Q || S % Q != 0 ||
      (uintptr_t)scratch % 16 != 0)
    return (int)cudaErrorInvalidValue;
  SsdParams p{};
  p.x = (const bf16*)x;
  p.bm = (const bf16*)bm;
  p.cm = (const bf16*)cm;
  p.da = (const float*)da;
  p.dt = (const float*)dt;
  p.y = (float*)y;
  p.state = (float*)state;
  const int64_t per = (int64_t)B * H * S;  // a multiple of 16
  p.seg = (float*)scratch;
  p.dth = p.seg + per;
  p.w = p.dth + per;
  p.st = p.w + per;
  int64_t* dst[13] = {&p.x_sb, &p.x_ss, &p.x_sh, &p.b_sb, &p.b_ss,
                      &p.c_sb, &p.c_ss, &p.a_sb, &p.a_ss, &p.a_sh,
                      &p.t_sb, &p.t_ss, &p.t_sh};
  for (int i = 0; i < 13; ++i) *dst[i] = strides[i];
  p.B = B;
  p.S = S;
  p.H = H;
  p.Q = Q;
  int err = set_smem(ssd_prep, prep_attr, prep_smem(kMaxQ));
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  ssd_prep<<<dim3((H + kPrepHeads - 1) / kPrepHeads, S / Q, B),
             kPrepHeads * kPrepWarps, prep_smem(Q), s>>>(p);
  err = N == 64 ? launch_n<64>(p, H, S, Q, B, s)
                : launch_n<128>(p, H, S, Q, B, s);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
