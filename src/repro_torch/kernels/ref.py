"""Plain PyTorch versions of the port's kernels (XOR parity, flash
attention).

The kernel wrappers fall back to these only for tensors on the CPU; the
tests hold them against the JAX reference, and each CUDA kernel against
them on the card (the `card` tests of `tests/test_torch_kernels.py` and
`tests/test_torch_flash.py`)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None,
                        block_k: int = 128,
                        round_p: torch.dtype | str | None = None
                        ) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D) in q's dtype, each
    operand read as float32 in its own floating type (`decode`), the
    output rounded as the reference rounds (`round_to`).

    The flash-attention kernel's function, computed as the kernel does:
    a loop over tiles of `block_k` keys with a running max, sum and
    accumulator in float32.  Query position i sits at i + Sk - Sq (causal
    aligned bottom-right); a key is kept when it is not in the future
    (causal) and `qpos - kpos < window` (window > 0, causal or not).  A
    row that keeps no key is 0.  Query head h reads key/value head
    h // (H // Hkv).  q, k, v may be any strided views (the kernel's
    (B,S,H,D)-transposed inputs among them); the result is contiguous.

    `round_p` (a 16-bit dtype, or "tf32") rounds P to the tensor cores'
    compute type before P V, as those kernels do (`round_tf32` for tf32),
    the row sums taking it unrounded; None (the Pallas kernel's function)
    keeps it in float32."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    bk = min(block_k, Sk)
    dev = q.device
    qf = decode(q).reshape(B, Hkv, G, Sq, D)
    qpos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G, Sq, 1), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=dev)
    for k0 in range(0, Sk, bk):
        k1 = min(k0 + bk, Sk) - 1
        # skip a tile that is outside every query's window, as the kernel
        # does (decided on the host, so the loop can be graph-captured);
        # the last query (position Sk - 1) sees every tile causally
        if window > 0 and (Sk - Sq) - k1 >= window:
            continue
        kpos = torch.arange(k0, k1 + 1, device=dev)[None, :]
        keep = torch.ones((Sq, kpos.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            keep &= kpos <= qpos
        if window > 0:
            keep &= (qpos - kpos) < window
        kt = decode(k[:, :, k0:k0 + bk])
        vt = decode(v[:, :, k0:k0 + bk])
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * scale
        s = s.masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new).masked_fill(~keep, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = p if round_p is None else round_tf32(p) if round_p == "tf32" \
            else p.to(round_p).float()
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", pv, vt)
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return round_to(out.reshape(B, H, Sq, D), q.dtype)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to tf32 (a float32 with its low 13 mantissa
    bits zero) to nearest, ties away from zero, as the tf32 kernel rounds P
    (`cvt.rna.tf32.f32`): half a unit (bit 12) added to the magnitude's
    bits, then the 13 bits cleared; NaN and the infinities unchanged."""
    x = x.float()
    b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = torch.where(torch.isfinite(x), (b + 0x1000) & 0xFFFFE000, b)
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32)


_TABLES: dict[tuple[torch.dtype, torch.device], torch.Tensor] = {}


def decode_table(dtype: torch.dtype, device) -> torch.Tensor:
    """(256,) float32 on `device`: the value of each byte of the float8
    `dtype`, as torch decodes it on the CPU (the reference's values:
    tests/test_torch_flash.py holds them to JAX's); made once a device.
    The kernels' arithmetic decoding is held to it bit for bit on the
    card."""
    key = (dtype, torch.device(device))
    t = _TABLES.get(key)
    if t is None:
        codes = torch.arange(256, dtype=torch.uint8)
        t = _TABLES[key] = codes.view(dtype).float().to(device)
    return t


def decode(t: torch.Tensor) -> torch.Tensor:
    """A floating tensor as float32: a float8 one through `decode_table`
    (the same on every device, whatever torch converts there)."""
    if t.dtype in FLOAT8 or t.dtype == torch.float8_e8m0fnu:
        return decode_table(t.dtype, t.device)[t.view(torch.uint8).long()]
    return t.float()


# The float8 formats: mantissa bits, exponent bias, largest finite value,
# and whether they are "fnuz" (no infinity, no negative zero, one NaN code
# 0x80).  float8_e8m0fnu (exponent only) is apart.
FLOAT8 = {torch.float8_e4m3fn: (3, 7, 448.0, False),
          torch.float8_e5m2: (2, 15, 57344.0, False),
          torch.float8_e4m3fnuz: (3, 8, 240.0, True),
          torch.float8_e5m2fnuz: (2, 16, 57344.0, True)}


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 `x` in `dtype`, rounded as the reference's `astype` rounds
    (XLA's conversion, ml_dtypes' rules): to nearest, ties to even, with
    each float8 format's own overflow, NaN and zero.  torch's own
    conversion differs for two formats (it saturates float8_e4m3fn where
    the reference gives NaN, and encodes |x| in float8_e8m0fnu where the
    reference gives NaN for x <= 0), so every float8 format is encoded
    here from the bits of `x`, the same on every device."""
    if dtype == torch.float8_e8m0fnu:
        return _round_e8m0(x.float())
    if dtype not in FLOAT8:
        return x.to(dtype)
    mbits, bias, top, fnuz = FLOAT8[dtype]
    x = x.float()
    b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = (b >> 24) & 0x80
    emin = 1 - bias                       # the least normal exponent
    e = (((b >> 23) & 0xFF) - 127).clamp(min=emin)
    # rounded to the format's spacing at |x| (2^(e - mbits)): exact scalings
    # by powers of two around a round to nearest even
    y = torch.round(x.abs() * _pow2(mbits - e)) * _pow2(e - mbits)
    yb = y.view(torch.int32).to(torch.int64)
    ye = (yb >> 23) - 127
    frac = (yb >> (23 - mbits)) & ((1 << mbits) - 1)
    normal = ((ye + bias) << mbits) | frac
    sub = (y * 2.0 ** (mbits - emin)).to(torch.int64)
    mag = torch.where(y == 0, 0, torch.where(ye >= emin, normal, sub))
    code = torch.where(mag == 0, 0, sign | mag) if fnuz else sign | mag
    nan = torch.full_like(code, 0x80) if fnuz else \
        sign | (0x7F if mbits == 3 else 0x7E)
    over = sign | 0x7C if dtype == torch.float8_e5m2 else nan
    code = torch.where(y > top, over, code)
    code = torch.where(torch.isnan(x), nan, code)
    return code.to(torch.uint8).view(dtype)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k in float32 for int64 k in [-126, 127], built from its bits (so
    exact on every device)."""
    return ((k + 127) << 23).to(torch.int32).view(torch.float32)


def _round_e8m0(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float8_e8m0fnu: the exponent of x, plus one when bit 22 of
    the mantissa is set and x is not a tie at 2^-127; NaN (0xFF) for x <= 0,
    infinities and NaN (the format has no sign and no zero)."""
    b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    e = b >> 23
    up = ((b & 0x400000) != 0) & (((b & 0x3FFFFF) != 0) | (e > 0))
    code = torch.where((x > 0) & (e < 255), e + up.to(torch.int64), 0xFF)
    return code.to(torch.uint8).view(torch.float8_e8m0fnu)


def bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a 1-, 2- or 4-byte tensor as int64."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    mask = {1: 0xFF, 2: 0xFFFF, 4: 0xFFFFFFFF}[t.element_size()]
    return t.view(view[t.element_size()]).to(torch.int64) & mask


def rounding_steps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Element by element, how many values of their (8- or 16-bit) type
    two tensors of that type are apart (-0 == +0): the largest.  Raises
    ValueError where the types differ or NaN sits in different places."""
    if got.dtype != want.dtype:
        raise ValueError(f"rounding_steps of {got.dtype} and {want.dtype}")
    nan = torch.isnan(decode(got))
    if not torch.equal(nan, torch.isnan(decode(want))):
        raise ValueError("NaN in different places")

    def key(t):               # monotone in the value; e8m0 has no sign
        b = bits(t)
        if t.dtype == torch.float8_e8m0fnu:
            return b
        top = 1 << (8 * t.element_size() - 1)
        return torch.where(b & top != 0, -(b & (top - 1)), b & (top - 1))
    steps = (key(got) - key(want)).abs().masked_fill(nan, 0)
    return int(steps.max()) if steps.numel() else 0


# row types whose XOR and narrowing go through the signed type of their
# width (the same bits): torch on the card lacks some unsigned operations
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def to_int32(row: torch.Tensor) -> torch.Tensor:
    """Integer elements as the reference stores them in int32 lanes: signed
    types sign-extended, unsigned ones zero-extended, 32-bit ones by their
    bits, 64-bit ones by their low 32 bits."""
    if row.dtype == torch.uint16:
        return row.view(torch.int16).to(torch.int32) & 0xFFFF
    return row.view(_SIGNED_VIEW.get(row.dtype, row.dtype)).to(torch.int32)


def xor_parity_ref(blocks: torch.Tensor) -> torch.Tensor:
    """blocks (K, N) of an integer type -> (N,) int32: the XOR of the rows
    (RAID-5 column), stored in int32 as `to_int32` does."""
    out = to_int32(blocks[0]).clone()
    for i in range(1, blocks.shape[0]):
        out.bitwise_xor_(to_int32(blocks[i]))
    return out


def reconstruct_ref(survivors, parity: torch.Tensor) -> torch.Tensor:
    """Recover one missing block: XOR of the survivors and the parity, each
    row of any integer type, in int32 (the XOR of rows stored by
    `to_int32` is the stored XOR: the extensions and the narrowing are
    bitwise)."""
    out = to_int32(parity).clone()
    for row in survivors:
        out.bitwise_xor_(to_int32(row))
    return out
