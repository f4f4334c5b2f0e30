"""Weights and states made on the device from the seed, in the type they
are served in, by a few large calls.

A leaf's values follow the first rule of the configuration's `init` list
whose pattern names it (its last key, its dotted path, or "*" for
every leaf).  Without one
they follow the leaf's kind in the program's parameter layout: a
"normal" matrix has std 1/sqrt(fan_in) (fan_in its second-to-last
dimension; the embedding std 1), a "zeros" leaf (norm weights, applied as
1 + w) std 0.1, and a "ones" leaf is 1.  Rules:

    ["<name>", "normal", std]          normal with that std
    ["<name>", "const", c]             every element c
    ["<name>", "log_uniform", lo, hi]  log of a uniform draw in [lo, hi]
    ["<name>", "dt_bias", lo, hi]      softplus^-1 of dt, log dt uniform
                                       in [log lo, log hi] (Mamba2's init)

The normal leaves, in sorted path order, take their values from one
stream of normal draws made in chunks of 2^28 elements, so a seed gives
the same values however the leaves are held.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 28


def _rule(path: tuple, rules: list):
    dotted = ".".join(path)
    for r in rules:
        if r[0] in (path[-1], dotted, "*"):
            return r
    return None


def _default(path: tuple, shape: tuple, kind: str) -> list:
    """The rule of a leaf that the configuration does not name."""
    if kind == "ones":
        return [path[-1], "const", 1.0]
    if kind == "zeros":
        return [path[-1], "normal", 0.1]
    if path[-1] == "embed":
        return [path[-1], "normal", 1.0]
    return [path[-1], "normal", 1.0 / math.sqrt(shape[-2])]


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def stream(leaves: list[tuple[tuple, tuple, str]], rules: list, dtype,
           seed: int, device):
    """(path, tensor) for each of `leaves` [(key path, shape, kind)], the
    normal leaves first in sorted path order, then the others: the
    values of `make`, one leaf alive at a time beside one chunk."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    leaves = [(p, s, _rule(p, rules) or _default(p, s, k))
              for p, s, k in sorted(leaves)]
    normal = [(p, s, r) for p, s, r in leaves if r[1] == "normal"]
    total = sum(math.prod(s) for _, s, _ in normal)
    chunk, pos, drawn = None, 0, 0
    for path, shape, r in normal:
        n = math.prod(shape)
        leaf = torch.empty(n, dtype=dtype, device=device)
        have = 0
        while have < n:
            if chunk is None or pos >= chunk.numel():
                size = min(CHUNK, total - drawn)
                chunk = torch.empty(size, dtype=dtype, device=device)
                chunk.normal_(generator=gen)
                drawn += size
                pos = 0
            take = min(n - have, chunk.numel() - pos)
            leaf[have:have + take] = chunk[pos:pos + take]
            have += take
            pos += take
        yield path, leaf.view(shape).mul_(r[2])
    for path, shape, r in leaves:
        kind = r[1]
        if kind == "normal":
            continue
        if kind == "const":
            leaf = torch.full(shape, float(r[2]), dtype=dtype, device=device)
        elif kind in ("log_uniform", "dt_bias"):
            u = torch.rand(shape, generator=gen, device=device,
                           dtype=torch.float32)
            lo, hi = float(r[2]), float(r[3])
            if kind == "log_uniform":
                leaf = torch.log(lo + (hi - lo) * u)
            else:
                dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                               * u)
                leaf = dt + torch.log(-torch.expm1(-dt))
            leaf = leaf.to(dtype)
        else:
            raise ValueError(f"unknown init rule {r}")
        yield path, leaf


def make(leaves: list[tuple[tuple, tuple, str]], rules: list, dtype,
         seed: int, device) -> dict:
    """A nested dict of tensors for `leaves` [(key path, shape, kind)],
    made from `seed` on `device` (`stream`'s values)."""
    out: dict = {}
    for path, leaf in stream(leaves, rules, dtype, seed, device):
        _set(out, path, leaf)
    return out
