"""Cost analyzer of a step's recorded aten ops: `repro.tools.hlo_cost` for
the port (the name is kept so that a reader finds the counterpart).

The reference parses the compiled HLO text of a jitted step.  PyTorch
runs eagerly, so here the program is the sequence of aten ops the step
dispatches, and `CostCounter` (a TorchDispatchMode) records it while the
step runs: on fake tensors under FakeTensorMode for the dry-run, where
nothing is allocated, or on real ones.  Under DTensor the counter lets
DTensor dispatch first, so it sees each device's LOCAL ops and the
collectives DTensor runs: every number is PER DEVICE, as the
reference's (a DTensor op at its global shape is never counted).  It sums:

  * product and convolution FLOPs (torch.utils.flop_counter's formulas:
    2 * M * N * K for a product);
  * collective bytes by kind (all-reduce / all-gather / reduce-scatter /
    all-to-all / collective-permute / collective-broadcast), operand
    sizes;
  * a traffic model: operand + result bytes of every op that computes
    (views and bookkeeping excluded).  Eager PyTorch fuses nothing, so
    this counts every intermediate through memory: an upper bound of
    what a fused program moves, NOT comparable with the reference's
    count over XLA fusions.

Loops.  A Python loop that the model declares with `models.layers.loop`
runs every trip unless the counter was made with `cut_loops=True` (the
dry-run of the long sequences): it then runs one trip, and that trip's
counts are multiplied by the trip count; so are those of its recompute
under remat and of the backward of the autograd nodes the trip made
(found by their sequence numbers).  That is exact when every trip does
the same work, as a while loop's body does; the first trip of a loop
whose carried input needs no gradient does less backward work than the
others.  `n_while` counts the loops so cut and `trip_counts` holds their
trip counts, as the reference's while loops.  The memory the counter
reports of such a run holds one trip's tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.models import layers as L

DTYPE_BYTES = {
    torch.bool: 1, torch.uint8: 1, torch.int8: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int16: 2, torch.float16: 2, torch.bfloat16: 2,
    torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8,
    torch.complex64: 8, torch.complex128: 16,
}

# collective op names (without a trailing "_" or "_coalesced") of the
# functional (_c10d_functional, its autograd twin) and c10d namespaces,
# by the reference's kind
_COLLECTIVE = {
    "all_gather_into_tensor": "all-gather", "allgather": "all-gather",
    "all_gather": "all-gather", "_allgather_base": "all-gather",
    "allgather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall": "all-to-all",
    "alltoall_base": "all-to-all",
    "broadcast": "collective-broadcast",
    "send": "collective-permute", "recv": "collective-permute",
    "recv_any_source": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# ops that move no bytes of their own
_BOOKKEEPING = {"detach", "alias", "lift_fresh", "empty", "empty_strided",
                "empty_like", "new_empty", "new_empty_strided", "device",
                "_local_scalar_dense", "wait_tensor",
                "_wrap_tensor_autograd", "set_", "resize_"}


def shape_bytes(shape, dtype) -> int:
    """Bytes of a tensor of `shape` and `dtype`."""
    return math.prod(shape) * DTYPE_BYTES[dtype]


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(tensors) -> int:
    return sum(shape_bytes(t.shape, t.dtype) for t in tensors
               if t.dtype in DTYPE_BYTES)


def _dot_kind(name: str) -> str | None:
    if name in ("mm", "bmm", "addmm", "baddbmm", "_scaled_mm"):
        return "dot"
    if "conv" in name:
        return "convolution"
    if "attention" in name:
        return "attention"
    return None


def collective_kind(func) -> str | None:
    ns, _, name = func._schema.name.partition("::")
    if ns not in _COLLECTIVE_NS:
        return None
    name = name.removesuffix("_").removesuffix("_coalesced")
    return _COLLECTIVE.get(name)


@dataclasses.dataclass
class CostReport:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    n_while: int = 0
    trip_counts: dict = dataclasses.field(default_factory=dict)
    flops_by_kind: dict = dataclasses.field(default_factory=dict)

    def as_dict(self):
        return dataclasses.asdict(self)


class CostCounter(TorchDispatchMode):
    """Records the aten ops run inside it into `report` (a CostReport),
    and each op with its multiplier into `ops` when `keep_ops` (for
    `hlo_top`).  `live_bytes` / `peak_bytes` follow the storages the
    recorded ops create: the memory a run needs above its inputs."""

    def __init__(self, *, cut_loops: bool = False, keep_ops: bool = False):
        super().__init__()
        self.report = CostReport()
        self.cut_loops = cut_loops
        self.ops: list | None = [] if keep_ops else None
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakSet()
        self._scales: list[int] = []          # the loops being cut, nested
        self._ranges: list[tuple[int, int, int]] = []
        self._paused = 0
        self._restore = []

    # -------------------------------------------------------------- hooks
    def __enter__(self):
        self._prev_hook = L.LOOP_HOOK[0]
        L.LOOP_HOOK[0] = self._loop
        self._pause_sharding_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        L.LOOP_HOOK[0] = self._prev_hook
        for obj, name, fn in self._restore:
            setattr(obj, name, fn)
        self._restore.clear()
        return super().__exit__(*exc)

    def _pause_sharding_propagation(self):
        """DTensor's sharding propagation runs an op once on fake tensors
        of the GLOBAL shapes to learn the output's metadata; those ops
        are not the device's work and are not counted."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        fn = getattr(ShardingPropagator, name)
        counter = self

        def paused(self_, *a, **kw):
            counter._paused += 1
            try:
                return fn(self_, *a, **kw)
            finally:
                counter._paused -= 1

        setattr(ShardingPropagator, name, paused)
        self._restore.append((ShardingPropagator, name, fn))

    @contextlib.contextmanager
    def _loop(self, name: str, n: int):
        if not self.cut_loops or n <= 1:
            yield n
            return
        self.report.trip_counts[name] = n
        self.report.n_while = len(self.report.trip_counts)
        self._scales.append(n)
        start = torch._C._autograd._get_sequence_nr()
        try:
            yield 1
        finally:
            self._scales.pop()
            self._ranges.append(
                (start, torch._C._autograd._get_sequence_nr(), n))

    def _scale(self) -> int:
        if self._scales:
            return math.prod(self._scales)
        node = torch._C._current_autograd_node()
        if node is not None and self._ranges:
            nr = node._sequence_nr()
            for lo, hi, n in self._ranges:
                if lo <= nr < hi:
                    return n
        return 1

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if DTensor in types:
            return NotImplemented      # DTensor runs the local ops here
        out = func(*args, **kwargs)
        if self._paused:
            return out
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        name = func._schema.name.partition("::")[2]
        m = self._scale()
        r = self.report
        kind = collective_kind(func)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if kind is not None:
            b = _bytes(ins) * m
            r.collective_bytes += b
            r.collectives[kind] = r.collectives.get(kind, 0) + b
            self._note(func, "collective", b, m, outs)
            return
        self._track(outs)
        if func.is_view or name in _BOOKKEEPING \
                or func.namespace == "prim":
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out) * m
            k = _dot_kind(name) or name
            r.flops += f
            r.flops_by_kind[k] = r.flops_by_kind.get(k, 0) + f
            self._note(func, "flops", f, m, outs)
        t = (_bytes(ins) + _bytes(outs)) * m
        r.traffic_bytes += t
        self._note(func, "traffic", t, m, outs)

    def _note(self, func, what, value, m, outs):
        if self.ops is not None and value:
            shape = tuple(outs[0].shape) if outs else ()
            self.ops.append((what, value, str(func), m, shape))

    def _track(self, outs):
        for t in outs:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int):
        self.live_bytes -= n


def count(fn, *args, cut_loops: bool = False, **kwargs):
    """(fn's result, CostReport of the ops it ran)."""
    with CostCounter(cut_loops=cut_loops) as c:
        out = fn(*args, **kwargs)
    return out, c.report
