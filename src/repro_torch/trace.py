"""The port's tracer: named spans and counters inside the program, off by
default.

A span is a `torch.profiler.record_function` range, so under a profiler
it lands on the kineto timeline, the clock of the device's operations: a
trace can then put an idle gap, or a kernel, down to the span the host
was in when it happened.  Spans nest; every name starts with `rt:` and is
listed in `SPANS`.

While tracing is off, `span` hands back one shared `nullcontext` (one
global read, no allocation, no call into the dispatcher) and `add` /
`add_device` return at once.  While it is on, `add` counts host integers
and `add_device` adds a device tensor's sum into an accumulator on its
device; neither synchronises.  `counters` reads the device accumulators
once, when it is called, beside the kernel modules' own launch counts
since the last `reset`.

    from repro_torch import trace
    trace.reset(); trace.enable()
    with torch.profiler.profile(...) as prof:
        ...                          # the program's spans over its kernels
    trace.disable(); trace.counters()
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.kernels import flash_attention, parity, ssd

SPANS = (
    "rt:prefill.forward",   # the prefill step's model forward
    "rt:prefill.head",      # the prefill step's unembedding and argmax
    "rt:train.cast",        # the train step's one cast of the parameters
    "rt:train.forward",     # a microbatch's loss (`steps.loss_fn`)
    "rt:train.backward",    # a microbatch's `torch.autograd.grad`
    "rt:train.accumulate",  # the f32 gradient sums over microbatches
    "rt:optim.adamw",       # `adamw.apply_updates`
    "rt:data.read",         # `TokenPipeline.batch_at`: the corpus reads
    "rt:data.to_device",    # the batch's copy to the trainer's device
    "rt:attn",              # a self-attention block (`attn_block`)
    "rt:attn.kernel",       # its attention proper: K3, chunked or scores
    "rt:mlp",               # a dense MLP block (`mlp_block`)
    "rt:moe",               # an MoE FFN (`moe_ffn`)
    "rt:moe.route",         # the router and its top-k
    "rt:moe.dispatch",      # the sort-based dispatch and the buffer fill
    "rt:moe.experts",       # the experts' batched products
    "rt:moe.combine",       # the gated sum back in token order
    "rt:moe.shared",        # the shared expert over every token
    "rt:mamba",             # a Mamba2 block (`zamba2._mamba_block`)
    "rt:mamba.ssd",         # its SSD, chunked or one decode step
    "rt:ckpt.save",         # `CheckpointManager.save`
    "rt:ckpt.host",         # a leaf brought to the host (`_host`)
    "rt:ckpt.write",        # create, write and close of a data or parity file
    "rt:ckpt.parity",       # a leaf's parity (`_parity_for`)
    "rt:ckpt.commit",       # the syncs, the manifest and the targets' commits
    "rt:ckpt.restore",      # `CheckpointManager.restore`
    "rt:ckpt.read",         # open, read and close of a leaf's data file
    "rt:ckpt.rebuild",      # a lost stripe rebuilt (`_reconstruct`)
    "rt:ckpt.decode",       # a leaf's bytes decoded (`_decode`)
    "rt:ckpt.retain",       # `CheckpointManager.retain`
)

COUNTERS = (
    "moe.assignments",      # (token, slot) assignments routed, T * top_k
    "moe.slots",            # expert buffer rows, E * C
    "moe.kept",             # assignments within capacity (device)
    "moe.kernel",           # MoE layers dispatched and combined by moe_rows
    "moe.plain",            # MoE layers that ran `_scatter`/`_combine` on
                            # the card (global dispatch)
    "ckpt.host_bytes",      # bytes of the leaves brought to the host
    "ckpt.write_bytes",     # bytes written to data and parity files
    "ckpt.read_bytes",      # bytes read of data, surviving stripes, parity
    "ckpt.rebuilt",         # stripes rebuilt from parity
    "ssd.chunked",          # blocks whose SSD ran `_ssd_chunked` on the card
)

_NULL = contextlib.nullcontext()
_NAMES = frozenset(SPANS)
_KNOWN = frozenset(COUNTERS)
_on = False
_host: dict[str, int] = {}
_device: dict[str, torch.Tensor] = {}
_launches_at_reset: dict[str, int] = {}


def span(name: str):
    """A context manager: the profiler range `name` while tracing is on,
    else a shared no-op."""
    if not _on:
        return _NULL
    if name not in _NAMES:
        raise ValueError(f"unknown span {name!r}: add it to trace.SPANS")
    return record_function(name)


def _known(name: str) -> None:
    if name not in _KNOWN:
        raise ValueError(f"unknown counter {name!r}: add it to "
                         f"trace.COUNTERS")


def add(name: str, n: int) -> None:
    """Counter `name` += the host integer `n` (tracing on only)."""
    if not _on:
        return
    _known(name)
    _host[name] = _host.get(name, 0) + int(n)


def add_device(name: str, t: torch.Tensor) -> None:
    """Counter `name` += the number of true (or the sum of integer)
    elements of `t`, taken on its device without a synchronisation
    (tracing on only, so that an off tracer launches nothing)."""
    if not _on:
        return
    _known(name)
    if isinstance(t, DTensor):
        t = t.to_local()
    n = t.detach().sum(dtype=torch.int64)
    if name in _device:
        _device[name].add_(n)
    else:
        _device[name] = n


def _launches() -> dict[str, int]:
    return {"flash.launches": flash_attention.LAUNCHES,
            "parity.launches": parity.LAUNCHES,
            "ssd.launches": ssd.LAUNCHES}


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Zero the counters; the kernels' launch counts start again from
    their values now."""
    _host.clear()
    _device.clear()
    _launches_at_reset.update(_launches())


def counters() -> dict:
    """{name: count} since the last `reset`: the host counters, the device
    ones (read here, one transfer a device) and the launches of K3, K1/K2
    and the SSD kernel."""
    out = dict(_host)
    on: dict[torch.device, list[str]] = {}
    for n, acc in _device.items():
        on.setdefault(acc.device, []).append(n)
    for names in on.values():
        out.update(zip(names, torch.stack([_device[n] for n in names])
                       .tolist()))
    for n, v in _launches().items():
        out[n] = v - _launches_at_reset.get(n, 0)
    return out
