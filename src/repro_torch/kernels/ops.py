"""Entry points to the port's kernels, as their callers use them.

`flash_attention` is the model's way to the attention kernel, with the
reference's block clamping and divisibility contract.

Stripe units are byte strings of unequal length.  `parity_bytes` lays
them out as the zero-padded rows of an int32 (K, N) array (0 is the XOR
identity, so padding never changes the parity), moves it to `device`,
computes the XOR there and returns the first max(len) bytes.  N is
padded to a multiple of 4 lanes so that every row starts on a 16-byte
boundary and the kernel can take its 16-byte path.

The rows are laid out in staging buffers that live as long as the
process (`_Staging`, one per device): a pinned host buffer for the rows,
one on the card, and a pinned one for the result, each grown by doubling
and never shrunk, so a call allocates nothing but the bytes it returns.
A call on the card is: copy each chunk into its row of the pinned
buffer and zero the rest of the row; one asynchronous copy to the card;
the kernel; one asynchronous copy of the result back; a synchronisation
of the stream; one copy into the returned bytes.  On the CPU the same
code runs on unpinned buffers, with the kernel's plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import parity as _par


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    block_q=128, block_k=128):
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D).  The blocks are
    clamped to the sequence lengths and must then divide them, as the
    reference's Pallas grid requires; the kernel's own tiles do not
    depend on them.  q, k, v may be strided views; the output has q's
    memory order (see `kernels.flash_attention`)."""
    block_q = min(block_q, q.shape[2])
    block_k = min(block_k, k.shape[2])
    if q.shape[2] % block_q or k.shape[2] % block_k:
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_k}) "
                         f"do not divide Sq={q.shape[2]}, Sk={k.shape[2]}")
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" without a usable card raises
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is false")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class _Staging:
    """The buffers of the parity calls on one device.  A call returns only
    after it has synchronised with the card (`_from_card`), so the next
    call may overwrite them.  That holds because the simulator is
    single-threaded: `core.sim.Simulator.parallel` runs its thunks in turn,
    never two parity calls at once."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.pin = dev.type == "cuda"
        self.bufs: dict[str, torch.Tensor] = {}

    def get(self, name: str, nbytes: int, device) -> torch.Tensor:
        """`nbytes` of the uint8 buffer `name` on `device`, grown by
        doubling when it is too small (pinned when on the host of a
        card: pinning is slow, so it is done rarely)."""
        buf = self.bufs.get(name)
        if buf is None or buf.numel() < nbytes:
            cap = max(nbytes, 2 * (0 if buf is None else buf.numel()))
            pin = self.pin and torch.device(device).type == "cpu"
            buf = self.bufs[name] = torch.empty(cap, dtype=torch.uint8,
                                                device=device,
                                                pin_memory=pin)
        return buf[:nbytes]


_STAGING: dict[torch.device, _Staging] = {}


def _staging(dev: torch.device) -> _Staging:
    st = _STAGING.get(dev)
    if st is None:
        st = _STAGING[dev] = _Staging(dev)
    return st


def _marshal(st: _Staging, chunks: list[bytes]) -> tuple[torch.Tensor, int]:
    """The chunks as the zero-padded rows of the host buffer, (K, row)
    uint8 with row a multiple of 16 bytes; and max(len).  One core copies
    each chunk through a numpy view: PyTorch's intra-op threads copy
    faster on an idle host but stall for many times as long on a busy
    one (PERF.md)."""
    n = max(len(c) for c in chunks)
    row = -(-n // 16) * 16
    host = st.get("host_in", len(chunks) * row, "cpu").view(len(chunks), row)
    arr = host.numpy()
    for i, c in enumerate(chunks):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
        arr[i, len(c):] = 0     # a longer chunk of an earlier call was here
    return host, n


def _to_card(st: _Staging, host: torch.Tensor) -> torch.Tensor:
    if st.dev.type == "cpu":
        return host
    dev = st.get("dev_in", host.numel(), st.dev).view(host.shape)
    return dev.copy_(host, non_blocking=True)


def _from_card(st: _Staging, parity: torch.Tensor) -> torch.Tensor:
    """The (row,) parity as host uint8; on the card, after synchronising
    the stream."""
    if st.dev.type == "cpu":
        return parity.view(torch.uint8)
    out = st.get("host_out", parity.numel() * 4, "cpu")
    out.view(torch.int32).copy_(parity, non_blocking=True)
    torch.cuda.current_stream(st.dev).synchronize()
    return out


def _unmarshal(out: torch.Tensor, n: int) -> bytes:
    return bytes(memoryview(out.numpy())[:n])


def parity_bytes(chunks: list[bytes], *, device) -> bytes:
    """XOR parity over byte chunks, each zero-padded to the longest."""
    st = _staging(resolve_device(device))
    host, n = _marshal(st, chunks)
    blocks = _to_card(st, host).view(torch.int32)
    return _unmarshal(_from_card(st, _par.xor_parity(blocks)), n)


def reconstruct_bytes(survivors: list[bytes], parity: bytes, length: int,
                      *, device) -> bytes:
    return parity_bytes(survivors + [parity], device=device)[:length]
