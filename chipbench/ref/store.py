"""The plain XOR parity of a RAID-0 striped file's columns, in NumPy."""
from __future__ import annotations

import numpy as np


def parity(data: bytes, stripe_size: int, stripe_count: int) -> bytes:
    """The XOR of the file's stripe columns (column i holds stripes i,
    i + count, ...), each zero-padded to the longest, as bytes of the
    longest column's length."""
    cols = [b"".join(data[s:s + stripe_size] for s in range(
        i * stripe_size, len(data), stripe_size * stripe_count))
        for i in range(stripe_count)]
    cols = [c for c in cols if c]
    n = max(len(c) for c in cols)
    out = np.zeros(n, np.uint8)
    for c in cols:
        out[:len(c)] ^= np.frombuffer(c, np.uint8)
    return out.tobytes()
