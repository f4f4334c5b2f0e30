#!/usr/bin/env python3
"""Kernel times and whole paths of the PyTorch/CUDA port (`src/repro_torch`)
on one NVIDIA card.

    python3 chip_smoke.py

Each hand-written kernel is held against its plain version by the card
tests beside its CPU tests (skipped without a card; no JAX needed):

    python -m pytest -q tests/test_torch_kernels.py tests/test_torch_flash.py \
        tests/test_torch_ssd.py tests/test_torch_moe_rows.py \
        tests/test_torch_granite.py

and each cell of the benchmark (`chipbench/`) holds its model whole.  This
script times the kernels alone, each beside its bound and its output held
once to its plain version's within the card tests' own limit
(`tests/_card.py`; K1 to the bit), counts each kernel's launches in one
request of each path that runs it, and runs the whole paths that neither
holds.  Phases, each printing one JSON line; any
failure exits non-zero before the last line (phases 3 and 7, the kernels'
checks, are the card tests now):

  1. the card's name and power limit (nvidia-smi);
  2. the build of every kernel from `src/repro_torch/csrc` (nvcc, sm_90a;
     ptxas's registers, spills and warnings);
  4. XOR parity (K1) times at the shapes of the main path, K=4 and 5 rows
     of 1 MiB (CUDA events, median; replayed from a CUDA graph for the
     card's own time, and issued from Python), beside the memory bound,
     the copy floor (a device-to-device copy of the same bytes), the
     launch floor (a kernel that writes one lane), the plain version and
     a chain of torch.bitwise_xor; K1 on uint8 and int64 rows at K=4,
     N=262144, and at phase 12's largest call, K=3 rows of 518,782,976
     bytes, in int32, uint8 and int64; then one LOV parity call of
     4 x 1 MiB from bytes to bytes, whole and split into its pieces;
  5. the main path: a raid5 file of 512 MiB at 1 MiB stripes, 4 data +
     1 parity, written, read clean, read degraded with ost1 dead,
     rebuilt onto a spare through lctl and truncated, all through
     `LustreCluster(device="cuda")` and `LustreClient`, every read
     byte-identical; the kernel's launches are counted over this phase
     only and must equal the LOV's parity and reconstruction calls;
  6. the raid5 section of BENCH_rpc.json reproduced with parity on the
     card; then phase 5's write once more on a fresh cluster, each parity
     call split into its pieces (`write_split`);
  8. flash attention (K3) times at the prefill shapes of qwen3-4b (B=2,
     S=4096, in bfloat16, float16 and float32 at D=128 and 64, and one
     layer of prefill_32k: B=1, S=32768), a gemma3-12b global layer
     (D=256, B=2, S=4096), zamba2-7b's shared block (D=112, H=Hkv=32,
     B=2, S=4096) and qwen3-4b's shape at D=96, 80 (wgmma at width 128),
     48 (wgmma at width 64), 100 (mma) and 320 (simt), and q bf16 with
     float8 (e4m3fn) k and v and all three e4m3fn at D=128 (wgmma) and
     all three at D=100 (mma; beside the card's float8 bound the design's
     16-bit one), q bf16 with f16 k and v and q f16 with e8m0fnu k and
     e5m2 v (wgmma_tf32, beside the design's tf32 bound), q f32 with bf16
     k and v at D=128 and all three e4m3fn at D=320 (PerTensor simt)
     beside simt<float> at D=128 and 320: each beside its bound (the
     largest of the products at the type's peak, the bytes, and one exp2
     a kept pair at 16 a clock an SM at nvidia-smi's clocks.max.sm), the
     plain version and scaled_dot_product_attention in the same dtype (a
     yardstick the port never calls);
  9. the main path, prefill: qwen3-4b at full width and depth (random f32
     parameters from a seed, bf16 compute) through build_prefill_step
     with attn_impl="flash" on 2 prompts of 4096 tokens; the wgmma kernel
     must launch once per layer (36 times), the logits at 10 positions must
     agree with the same step on attn_impl="ref", and two faults planted
     in the flash call (causal=False, a window of 2048) must fail that
     comparison; 9b: the same in float16 compute (36 launches of the
     float16 wgmma kernel, "ref" in float16 finite, within 5 %, both
     planted faults caught);
 10. in f32 compute, the flash prefill of two 64-token prompts against the
     decode chain's logits at position 63;
 11. the main path, serving: BatchedServer (on "cuda", its default)
     answers 4 requests with prompts of 8-64 tokens, 16 new tokens each;
 12. the main path, training: qwen3-4b at full width and vocabulary, 2
     layers, the train_4k shape cut to 4 sequences of 4096 tokens (4
     microbatches), f32 parameters, bf16 compute, remat, attn_impl
     "auto"; Trainer(cluster, cfg).run(3) on LustreCluster(osts=4,
     ost_failover=True, max_cached_mb=0, device="cuda") with ost1 failing
     before the third step, finite losses, no flash launch, and the
     parity-coded checkpoint at step 3 (one XOR launch a leaf); one
     stripe object of params.embed lost, then Trainer.resume rebuilds it
     on the card (one launch), the restored state equals the saved one
     byte for byte, and two more steps of each trainer give bit-equal
     losses; then the same two f32 train steps (B=1, S=64) on the card
     and on the CPU agree within 1e-4;
 13. the entry points (`python -m repro_torch.examples.*`, the
     checkpoint and parity benchmarks) on the card: quickstart (a fresh
     process) and failover_demo print what their CPU runs print;
     serve_batched, f32 from one initial state, reads the same KiB of
     weights as its CPU run and its 10 losses agree within 1e-4;
     bench_checkpoint's dict equals its CPU run; bench_parity's kernel
     rows are bit-exact and timed beside the bound; train_e2e --large
     (200 steps of 8 x 128 tokens, 10 parity-coded checkpoints, ost1
     killed at step 50, a resume at step 100) has finite losses, the last
     below the first, and the expected checkpoints.  Every XOR launch,
     counted around each entry point, is one parity call of the LOV or
     the checkpoint manager;
 14. the MoE path: phi3.5-moe at full width, depth cut 32
     -> 4 (random f32 parameters from the seed, 21.9 GB): a) the bf16
     prefill of 2 x 4096 tokens through build_prefill_step on "flash"
     (4 wgmma launches; the tokens dropped at C=1280 printed per layer)
     against the same step on "ref", routing compared, and a planted
     causal=False that must fail the check; c) BatchedServer on 4
     requests, and the f32 prefill against the decode chain; b) at depth
     1, f32, card against CPU: experts, drops and aux equal, logits
     within 1e-4; d) one f32 train step at depth 1 against the CPU, run
     twice on the card with bit-equal results; e) the Trainer on the
     smoke config with parity: 3 steps, a checkpoint (one K1 launch a
     leaf), a lost stripe rebuilt by Trainer.resume (one launch), the
     state equal byte for byte, bit-equal losses after;
 15. the other families at full width, each freed before the next: a
     bf16 prefill with its K3 launches by variant (dbrx-132b at depth 1:
     1 wgmma; whisper-tiny whole, 384 decoder tokens: 4; paligemma-3b
     whole and gemma3-12b's first 5:1 group: none; rwkv6-3b whole, 1024
     tokens: none; zamba2-7b whole, 2 x 4096: 13 at D=112, against "ref"
     with a planted fault), whisper's and rwkv6's decode continuing their
     f32 prefill, gemma3's 1,100 f32 decode steps on the ring-buffered
     and the full cache, and each family's f32 card-vs-CPU check;
 16. the multi-device path on a one-rank NCCL mesh (`--parallel-only`);
 17. the SSD kernel (`kernels.ssd`, csrc/ssd.cu) timed at the docs cell's
     shapes (zamba2-7b's H = 112, P = N = 64, chunk 256, S = 512 ...
     4096, B = 1), then at Granite 4.0-H Small's N = 128 (H = 128, P =
     64) beside N = 64 (H = 112) at S = 2048 ... 8192, a block a call:
     graph replays beside `_ssd_chunked` and the bound (bytes at 3.35
     TB/s, products at the bf16 peak, one exp a kept pair at 16 a clock
     an SM) with TF32 off; 17b: one bf16 request each of zamba2-7b whole
     (4096 tokens), Granite 4.0-H Small whole (8192) and the chat cell's
     phi3.5-moe stage (16 layers, 1024), counted: one SSD launch a Mamba2
     block, `moe.kernel` and two row-kernel launches an MoE layer, none
     of `ssd.chunked` and `moe.plain`; and a bf16 training step of
     phi3.5-moe at 2 layers: `moe.plain` once a layer, no row-kernel
     launch, finite gradients;
 18. the MoE's row kernels (`kernels.moe_rows`, csrc/moe_rows.cu) timed
     at Granite 4.0-H Small's routing (72 experts, top-10, T = 2048 ...
     8192) and the chat cell's (16, top-2, T = 128 ... 8192), d = 4096,
     router-made routings at capacity 1.25: graph replays beside each
     kernel's bound (bytes at 3.35 TB/s) and beside `_scatter` /
     `_combine`.

Then the kernel summary line, the nvidia-smi line, and last {"ok": true,
"device": {...}}.  Exits non-zero without a result when no CUDA card is
usable or the port's sources are missing.

    python3 chip_smoke.py --flash-only

times the flash-attention kernel alone (phases 1, 2, 8); it prints no
result line.  Run it under `timeout`: a fault of its mbarrier pipeline
traps after seconds, and the timeout bounds the rest.  A copy of this
file in another checkout times that checkout's kernels (an older tree's
beside this one's, in one call on one card).

    python3 chip_smoke.py --parity-only

is the same for the XOR parity kernel (phases 1, 2, 4 and `write_split`);
no result line.

    python3 chip_smoke.py --train-only

runs phases 1, 2 and 12; no result line.

    python3 chip_smoke.py --entry-only

runs phases 1, 2 and 13; no result line.

    python3 chip_smoke.py --families-only

runs phases 1, 2, 14 and 15; no result line.

    python3 chip_smoke.py --parallel-only

runs phases 1, 2 and 16; no result line.

    python3 chip_smoke.py --ssd-only

runs phases 1, 2 (every library) and 17; no result line.

    python3 chip_smoke.py --moe-only

runs phases 1, 2 (the MoE rows library) and 18; no result line.
"""
from __future__ import annotations

import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# tests/_card.py: the one limit each kernel is held to, shared with the
# card tests (imported where a timing checks its kernel's output)
sys.path.append(str(ROOT / "tests"))

# the H100 SXM's peak rates, the denominators of every bound below
from repro_torch.kernels.hardware import (  # noqa: E402
    BF16_FLOPS_PER_S, F32_FLOPS_PER_S, FP8_FLOPS_PER_S, HBM_BYTES_PER_S,
    INT32_OPS_PER_S, TF32_FLOPS_PER_S, exp2_per_s)

MAIN_MIB = 512
STRIPE = 1 << 20
SEED = 20240611


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi's clocks.max.sm), the clock
    of the exponentials' bound."""
    return float(nvidia_smi("clocks.max.sm").split()[0])


# K1's narrow and wide row types, timed beside int32 (phase 4): the XOR
# stored in int32 lanes, as the Pallas kernel stores it
INT_TIMED = ("uint8", "int64")


def int_rows(torch, k, n, dname, seed, device):
    """(k, n) random rows of the integer type `dname` on `device`: random
    bytes, viewed as the type."""
    item = getattr(torch, dname).itemsize
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (k, n * item), dtype=torch.uint8,
                      generator=g, device=device)
    return x.view(getattr(torch, dname))


def time_on_card(torch, fn, pool, reps=15) -> dict:
    """Median ms per call of `fn` over `reps` runs, each cycling once
    through `pool` (sized past the 50 MB L2, so every call reads device
    memory), timed with CUDA events two ways:

      graph_ms  - the calls captured once in a CUDA graph and replayed:
                  the card's own time, with no host in between;
      stream_ms - the calls issued one by one from Python, as a caller
                  issues them: bound by the host when a call is short."""
    def median_ms(run):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / len(pool))
        return statistics.median(times)

    def issue_all():
        for x in pool:
            fn(x)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm up, as capture asks
        issue_all()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        issue_all()
    graph.replay()
    torch.cuda.synchronize()
    out = {"graph_ms": median_ms(graph.replay),
           "stream_ms": median_ms(issue_all)}
    del graph
    return out


def bound_ms(k, n, item=4) -> tuple[float, str]:
    """K1's least time on k rows of n elements of `item` bytes: the rows
    read once and n int32 lanes written once at the memory rate, or its
    k - 1 XORs a lane at the int32 rate."""
    by_bytes = (k * item + 4) * n / HBM_BYTES_PER_S * 1e3
    by_ops = (k - 1) * n / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def held_to_the_bit(torch, parity, ref, rows):
    """K1's parity of `rows` equal to its plain version's, bit for bit."""
    if not torch.equal(parity.xor_parity(rows), ref.xor_parity_ref(rows)):
        raise AssertionError(f"xor_parity on {tuple(rows.shape)} "
                             f"{rows.dtype} rows differs from the plain "
                             "version")


def time_rows(torch, parity, ref, dev, dname, k, n, reps=15) -> dict:
    """K1 and its plain version on (k, n) rows of the integer type
    `dname`, a pool past the 50 MB L2 (one call's rows where they alone
    are larger), K1's output held to the bit, timed beside `bound_ms`."""
    item = getattr(torch, dname).itemsize
    count = -(-(96 << 20) // (k * n * item))       # > 96 MiB of inputs
    pool = [int_rows(torch, k, n, dname, 31 * i + k, dev)
            for i in range(count)]
    held_to_the_bit(torch, parity, ref, pool[0])
    kern = time_on_card(torch, parity.xor_parity, pool, reps)
    plain = time_on_card(torch, ref.xor_parity_ref, pool, reps)
    del pool
    torch.cuda.empty_cache()
    b, by = bound_ms(k, n, item)
    return {"K": k, "N": n, "bytes": (k * item + 4) * n,
            "ms": kern["graph_ms"], "stream_ms": kern["stream_ms"],
            "plain_ms": plain["graph_ms"], "bound_ms": b, "bound_by": by,
            "bound_share": b / kern["graph_ms"], "library_ms": None}


def time_kernel(torch, parity, ref, ops, dev) -> dict:
    """Phase 4 at the main path's shapes (K=4 and 5 rows of 1 MiB): the
    kernel (its output held to the bit), the plain version, the chain of
    K-1 torch.bitwise_xor calls, and the copy floor: a device-to-device
    Tensor.copy_ that moves the same (K+1)*N*4 bytes (it reads and writes
    (K+1)*N*2), a yardstick of what the card moves at this size, which
    the port never calls; and the launch floor, the graph-replayed time
    of a PyTorch kernel that zeroes one lane, the least a kernel node
    costs here.  Then `time_rows` on INT_TIMED's rows at K=4, N=262144,
    and at phase 12's largest call (the (vocab, d) embedding's leaf: K=3
    rows of 518,782,976 bytes) in int32 and INT_TIMED; then one whole
    parity call of the LOV and its split (`split_call`)."""
    def chain(x):
        acc = torch.bitwise_xor(x[0], x[1]) if x.shape[0] > 1 else x[0]
        for i in range(2, x.shape[0]):
            acc = torch.bitwise_xor(acc, x[i])
        return acc

    out = {}
    lanes = [torch.empty(1, dtype=torch.int32, device=dev) for _ in range(64)]
    launch_floor = time_on_card(torch, torch.Tensor.zero_, lanes)["graph_ms"]
    n = STRIPE // 4
    for k in (4, 5):
        count = -(-(96 << 20) // (k * n * 4))     # > 96 MiB of inputs
        pool = [int_rows(torch, k, n, "int32", 31 * i + k, dev)
                for i in range(count)]
        b, by = bound_ms(k, n)
        held_to_the_bit(torch, parity, ref, pool[0])
        kern = time_on_card(torch, parity.xor_parity, pool)
        plain = time_on_card(torch, ref.xor_parity_ref, pool)
        chained = time_on_card(torch, chain, pool)
        del pool
        half = (k + 1) * n * 2                     # bytes read, and written
        copies = [(torch.empty(half, dtype=torch.uint8, device=dev),
                   torch.empty(half, dtype=torch.uint8, device=dev))
                  for _ in range(-(-(96 << 20) // half))]
        floor = time_on_card(torch, lambda c: c[1].copy_(c[0]), copies)
        del copies
        out[k] = {"K": k, "N": n,
                  "ms": kern["graph_ms"], "stream_ms": kern["stream_ms"],
                  "plain_ms": plain["graph_ms"],
                  "plain_stream_ms": plain["stream_ms"],
                  "chain_bitwise_xor_ms": chained["graph_ms"],
                  "copy_floor_ms": floor["graph_ms"],
                  "launch_floor_ms": launch_floor,
                  "bound_ms": b, "bound_by": by,
                  "bound_share": b / kern["graph_ms"],
                  "copy_floor_share": b / floor["graph_ms"]}
    out["typed"] = {d: time_rows(torch, parity, ref, dev, d, 4, n)
                    for d in INT_TIMED}
    cfg = train_config().model
    row_bytes = 4 * leaf_row_lanes(cfg.vocab * cfg.d_model * 4)
    out["large"] = {d: time_rows(torch, parity, ref, dev, d, TRAIN_STRIPES,
                                 row_bytes // getattr(torch, d).itemsize,
                                 reps=5)
                    for d in ("int32", *INT_TIMED)}
    # one whole parity call of the LOV: 4 units of 1 MiB from host bytes
    # to parity bytes (marshal, copy in, kernel, copy out, unmarshal)
    g = torch.Generator().manual_seed(SEED)
    units = [torch.randint(0, 256, (STRIPE,), dtype=torch.uint8,
                           generator=g).numpy().tobytes() for _ in range(4)]
    for _ in range(3):
        ops.parity_bytes(units, device=dev)
    wall = []
    for _ in range(30):
        t0 = time.perf_counter()
        ops.parity_bytes(units, device=dev)
        wall.append((time.perf_counter() - t0) * 1e3)
    out["parity_bytes_call_ms"] = statistics.median(wall)
    out["parity_bytes_split_ms"] = split_call(torch, ops, parity, units, dev)
    emit("kernel_time", **{str(k): v for k, v in out.items()})
    return out


SPLIT = ("marshal", "to_card", "kernel", "from_card", "unmarshal")


def split_one(torch, ops, parity, chunks, dev) -> tuple[bytes, list]:
    """One `ops.parity_bytes` call run piece by piece as the call runs
    it, the pieces separated by synchronisations: marshal (the chunks
    into the pinned rows), to_card (one copy), kernel (launch and run),
    from_card (one copy back and the call's own synchronisation),
    unmarshal (the returned bytes).  Returns the bytes and the ms of each
    piece on the host clock."""
    st = ops._staging(ops.resolve_device(dev))
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    host, n = ops._marshal(st, chunks)
    t.append(time.perf_counter())
    blocks = ops._to_card(st, host)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    p = parity.xor_parity(blocks.view(torch.int32))
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    out = ops._from_card(st, p)
    t.append(time.perf_counter())
    got = ops._unmarshal(out, n)
    t.append(time.perf_counter())
    return got, [(t[j + 1] - t[j]) * 1e3 for j in range(len(SPLIT))]


def marshal_by_threads(torch, st, chunks):
    """A yardstick for the marshal piece: the chunks copied into the same
    host rows by PyTorch's intra-op threads (Tensor.copy_ from a tensor
    over each chunk's buffer) instead of by numpy on one core."""
    import warnings

    row = -(-max(len(c) for c in chunks) // 16) * 16
    host = st.bufs["host_in"][:len(chunks) * row].view(len(chunks), row)
    with warnings.catch_warnings():     # bytes are read-only; only read
        warnings.simplefilter("ignore", UserWarning)
        for j, c in enumerate(chunks):
            if c:
                host[j, :len(c)].copy_(torch.frombuffer(c,
                                                        dtype=torch.uint8))


def split_call(torch, ops, parity, units, dev, reps=30) -> dict:
    """Median ms of each piece (`split_one`) of one parity call on the
    same units, call after call; beside them, the marshal copies done by
    PyTorch's threads instead (`marshal_by_threads`), and the unmarshal
    when every call's bytes are kept (fresh host memory each time, as the
    LOV keeps them)."""
    times = {p: [] for p in SPLIT}
    threads_ms, kept_ms, kept = [], [], []
    want = ops.parity_bytes(units, device=dev)
    st = ops._staging(ops.resolve_device(dev))
    for i in range(reps + 3):
        got, ms = split_one(torch, ops, parity, units, dev)
        if got != want:
            raise AssertionError("the split parity call differs from "
                                 "parity_bytes")
        # yardsticks, not pieces
        t0 = time.perf_counter()
        marshal_by_threads(torch, st, units)
        t1 = time.perf_counter()
        kept.append(bytes(memoryview(want)))      # a copy, as _unmarshal
        t2 = time.perf_counter()
        del got           # the next call's bytes may reuse its pages
        if i >= 3:                                 # warm
            for name, v in zip(SPLIT, ms):
                times[name].append(v)
            threads_ms.append((t1 - t0) * 1e3)
            kept_ms.append((t2 - t1) * 1e3)
    split = {name: statistics.median(v) for name, v in times.items()}
    split["sum"] = sum(split.values())
    split["marshal_by_threads"] = statistics.median(threads_ms)
    split["unmarshal_bytes_kept"] = statistics.median(kept_ms)
    return split


def write_split(torch, ops, parity, dev, mib=MAIN_MIB) -> dict:
    """Where a write-path parity call of phase 5 spends its time: phase
    5's raid5 write of `mib` MiB on a fresh cluster, each LOV parity call
    run piece by piece (`split_one`) and its chunks then copied once more
    by `marshal_by_threads`; the median ms of each piece over the write's
    calls, and the median and mean of the whole call.  It makes clients,
    which moves the simulator's id sequences, so it runs after phases 5
    and 6, whose counts and virtual times depend on them."""
    import numpy as np

    from repro_torch.core import LustreCluster
    from repro_torch.fsio import LustreClient

    data = np.random.default_rng(SEED).bytes(mib << 20)
    c = LustreCluster(osts=5, mdses=1, clients=3, spare_osts=1, device=dev)
    fs = LustreClient(c, 0).mount()
    times = {p: [] for p in SPLIT + ("call", "marshal_by_threads")}
    real = ops.parity_bytes
    st = ops._staging(ops.resolve_device(dev))

    def timed(chunks, *, device):
        t0 = time.perf_counter()
        got, ms = split_one(torch, ops, parity, chunks, device)
        t1 = time.perf_counter()
        marshal_by_threads(torch, st, chunks)       # yardstick
        times["marshal_by_threads"].append(
            (time.perf_counter() - t1) * 1e3)
        for name, v in zip(SPLIT, ms):
            times[name].append(v)
        times["call"].append((t1 - t0) * 1e3)
        return got

    ops.parity_bytes = timed
    try:
        fh = fs.creat("/f", stripe_count=4, stripe_size=STRIPE,
                      pattern="raid5")
        fs.write(fh, data, offset=0)
        fs.close(fh)
    finally:
        ops.parity_bytes = real
    out = {name: statistics.median(v) for name, v in times.items()}
    out["call_mean"] = statistics.mean(times["call"])
    out["unmarshal_mean"] = statistics.mean(times["unmarshal"])
    out["calls"] = len(times["call"])
    emit("write_split", mib=mib, **out)
    return out


def qkv(torch, B, H, Hkv, Sq, Sk, D, dtype, seed, dev):
    """q (B,H,Sq,D), k, v (B,Hkv,Sk,D) from `seed`, all of `dtype` or each
    of its own where `dtype` is a tuple of three (a float8 tensor rounded
    from normal samples as the plain version rounds; float8_e8m0fnu,
    which has no sign and no zero, from their magnitudes kept at 2^-126
    or more: a sample of 0 encodes as NaN)."""
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(seed)
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,) * 3

    def mk(heads, S, dt):
        x = torch.randn((B, heads, S, D), generator=g, device=dev)
        if dt == torch.float8_e8m0fnu:
            x = x.abs().clamp_min(2.0 ** -126)
        return ref.round_to(x, dt)
    return (mk(H, Sq, dtypes[0]), mk(Hkv, Sk, dtypes[1]),
            mk(Hkv, Sk, dtypes[2]))


def flash_cost(B, H, Hkv, S, D, dtype, clock_mhz, peak=None) -> dict:
    """flops, bytes and exponentials of causal attention at Sq == Sk == S
    in `dtype` (a name, or the names of q's, k's and v's types), and the
    bound (ms): the largest of three terms, the products at the card's
    peak for the widest input type (FMA for float32, the tensor cores'
    for 16-bit types, their float8 rate where all three are float8; or at
    `peak` FLOP/s, a design's own rate), the bytes (each input read once
    in its type, the output written once in q's) at the memory rate, and
    one exp2 a kept (query, key) pair at the special function units' rate
    at `clock_mhz`.  `bound_by` is "operations" (products or exp2) or
    "bytes", `term` the term itself."""
    pairs = B * H * (S * (S + 1) / 2)
    flops = 4.0 * D * pairs                        # QK^T and PV, kept pairs
    names = dtype if isinstance(dtype, tuple) else (dtype,) * 3
    item = [4 if n == "float32" else 1 if n.startswith("float8") else 2
            for n in names]
    nbytes = (2 * item[0] * B * H * S * D
              + (item[1] + item[2]) * B * Hkv * S * D)
    peak = peak or (F32_FLOPS_PER_S if max(item) == 4 else
                    BF16_FLOPS_PER_S if max(item) == 2 else FP8_FLOPS_PER_S)
    terms = {"products": flops / peak * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "exp2": pairs / exp2_per_s(clock_mhz) * 1e3}
    term = max(terms, key=terms.get)
    return {"flops": flops, "bytes": nbytes, "exp2": pairs,
            "bound_ms": terms[term], "terms_ms": terms, "term": term,
            "bound_by": "bytes" if term == "bytes" else "operations"}


# K3's timed shapes, causal: the qwen3-4b prefill of the main path in bf16
# and float16 (phase 9b) and float32 (D=128 and 64), one layer of
# qwen3-4b's prefill_32k, a global layer of gemma3-12b (D=256), zamba2-7b's
# shared block (D=112, H = Hkv = 32), and head dims off the compiled widths
# at the main path's shape: 96 and 80 on the 128-wide wgmma pipeline, 48 on
# the 64-wide one, 100 on mma, 320 on simt; each name ends in the variant
# that runs it where that is not wgmma (name, dtype, B, H, Hkv, S, D,
# reps)
FLASH_TIMED = (("main", "bfloat16", 2, 32, 8, 4096, 128, 9),
               ("prefill_32k", "bfloat16", 1, 32, 8, 32768, 128, 3),
               ("gemma3_d256", "bfloat16", 2, 16, 8, 4096, 256, 9),
               ("zamba2_d112", "bfloat16", 2, 32, 32, 4096, 112, 9),
               ("main_f16", "float16", 2, 32, 8, 4096, 128, 9),
               ("d96", "bfloat16", 2, 32, 8, 4096, 96, 9),
               ("d80", "bfloat16", 2, 32, 8, 4096, 80, 9),
               ("d48_wgmma", "bfloat16", 2, 32, 8, 4096, 48, 9),
               ("d100_mma", "bfloat16", 2, 32, 8, 4096, 100, 9),
               ("d320_simt", "bfloat16", 2, 32, 8, 4096, 320, 3),
               ("main_f32", "float32", 2, 32, 8, 4096, 128, 3),
               ("f32_d64", "float32", 2, 32, 8, 4096, 64, 3))


def time_flash(torch, fa, ref, dev) -> dict:
    """K3 at FLASH_TIMED's shapes: the kernel (on contiguous inputs, and
    on the strided (B,S,H,D) views the model passes), the plain version
    and the library call (scaled_dot_product_attention in the same dtype,
    a yardstick only), each timed; the kernel's output on contiguous
    inputs held to the plain version's element by element
    (`_card.scaled_ok`, the card tests' limit at long sequences)."""
    import _card

    sdpa = torch.nn.functional.scaled_dot_product_attention
    clock = sm_clock_mhz()
    out = {}
    for name, dname, B, H, Hkv, S, D, reps in FLASH_TIMED:
        q, k, v = qkv(torch, B, H, Hkv, S, S, D, getattr(torch, dname), 7,
                      dev)
        if not _card.scaled_ok(fa.flash_attention(q, k, v), q, k, v):
            raise AssertionError(f"flash_attention at {name} differs from "
                                 "the plain version")
        pool = [(q, k, v)]
        views = [tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in (q, k, v))]
        cost = flash_cost(B, H, Hkv, S, D, dname, clock)
        kern = time_on_card(torch, lambda t: fa.flash_attention(*t), pool,
                            reps)
        strided = time_on_card(torch, lambda t: fa.flash_attention(*t),
                               views, reps)
        plain = time_on_card(torch, lambda t: ref.flash_attention_ref(*t),
                             pool, reps)
        lib = time_on_card(torch, lambda t: sdpa(*t, is_causal=True,
                                                 enable_gqa=True), pool, reps)
        variant = fa.route(q, k, v)
        out[name] = {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
                     "dtype": dname, "variant": variant,
                     "strided_variant": fa.route(*views[0]),
                     "width": fa.width(variant, D),
                     "flops": cost["flops"],
                     "bytes": cost["bytes"], "exp2": cost["exp2"],
                     "ms": kern["graph_ms"], "stream_ms": kern["stream_ms"],
                     "strided_ms": strided["graph_ms"],
                     "plain_ms": plain["graph_ms"],
                     "library_ms": lib["graph_ms"],
                     "bound_ms": cost["bound_ms"],
                     "bound_by": cost["bound_by"], "bound_term": cost["term"],
                     "bound_terms_ms": cost["terms_ms"],
                     "bound_share": cost["bound_ms"] / kern["graph_ms"],
                     "sm_clock_mhz": clock,
                     "tflops": cost["flops"] / kern["graph_ms"] / 1e9}
        del q, k, v, pool, views
        torch.cuda.empty_cache()
    emit("kernel_time", kernel="flash_attention", **out)
    return out


# phase 8's other types at the main path's shape: on the 16-bit tensor
# cores (compute type bfloat16) q bf16 with float8 (e4m3fn) k and v, and
# all three e4m3fn, on wgmma at D=128; all three e4m3fn at D=100 on mma
# (100-byte rows, which the TMA cannot take); on the tf32 kernel q bf16
# with f16 k and v, and q f16 with e8m0fnu k and e5m2 v; on the PerTensor
# simt kernel q f32 with bf16 k and v at D=128 and all three e4m3fn at
# D=320; and simt<float> at D=128 and 320, the yardsticks of the
# PerTensor kernel (name, (q, k, v types), B, H, Hkv, S, D, reps).  No
# library call takes a mix; SDPA in float32 is timed beside the float32
# cases.
FLASH_TYPED_TIMED = (
    ("bf16_q_e4m3fn_kv", ("bfloat16", "float8_e4m3fn", "float8_e4m3fn"),
     2, 32, 8, 4096, 128, 9),
    ("e4m3fn", ("float8_e4m3fn",) * 3, 2, 32, 8, 4096, 128, 9),
    ("e4m3fn_d100_mma", ("float8_e4m3fn",) * 3, 2, 32, 8, 4096, 100, 9),
    ("bf16_q_f16_kv", ("bfloat16", "float16", "float16"),
     2, 32, 8, 4096, 128, 9),
    ("f16_q_e8m0_k_e5m2_v", ("float16", "float8_e8m0fnu", "float8_e5m2"),
     2, 32, 8, 4096, 128, 9),
    ("f32_q_bf16_kv", ("float32", "bfloat16", "bfloat16"),
     2, 32, 8, 4096, 128, 3),
    ("f32_d128", ("float32",) * 3, 2, 32, 8, 4096, 128, 3),
    ("e4m3fn_d320", ("float8_e4m3fn",) * 3, 2, 32, 8, 4096, 320, 3),
    ("f32_d320", ("float32",) * 3, 2, 32, 8, 4096, 320, 3))
# the rate at which each route's design takes its products: 16-bit for
# the tensor-core routes that decode float8 (an fp8 P V would round P to
# 3 mantissa bits where the reference keeps float32), tf32 for wgmma_tf32,
# the FMA units' for simt
DESIGN_RATE = {"wgmma": BF16_FLOPS_PER_S, "mma": BF16_FLOPS_PER_S,
               "wgmma_tf32": TF32_FLOPS_PER_S, "simt": F32_FLOPS_PER_S}


def time_flash_types(torch, fa, ref, dev) -> dict:
    """K3 at FLASH_TYPED_TIMED, its output held to the plain version's on
    the route it takes (`_card.close_on_route`), then it and its plain
    version timed beside the card's bound (the products at the rate of
    the widest input type: float8's where all are float8) and the
    design's (`design_bound_ms`: the products at the rate of the route
    that runs them, DESIGN_RATE), and SDPA in float32 where all three are
    float32."""
    import _card

    sdpa = torch.nn.functional.scaled_dot_product_attention
    clock = sm_clock_mhz()
    out = {}
    for name, names, B, H, Hkv, S, D, reps in FLASH_TYPED_TIMED:
        dts = tuple(getattr(torch, n) for n in names)
        q, k, v = qkv(torch, B, H, Hkv, S, S, D, dts, 7, dev)
        _card.close_on_route(fa.flash_attention(q, k, v), q, k, v)
        variant = fa.route(q, k, v)
        cost = flash_cost(B, H, Hkv, S, D, names, clock)
        design = flash_cost(B, H, Hkv, S, D, names, clock,
                            peak=DESIGN_RATE[variant])
        kern = time_on_card(torch, lambda t: fa.flash_attention(*t),
                            [(q, k, v)], reps)
        plain_t = time_on_card(torch, lambda t: ref.flash_attention_ref(*t),
                               [(q, k, v)], reps)
        lib = time_on_card(torch, lambda t: sdpa(
            *t, is_causal=True, enable_gqa=True), [(q, k, v)], reps)[
                "graph_ms"] if set(names) == {"float32"} else None
        out[name] = {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
                     "dtypes": names, "variant": variant,
                     "width": fa.width(variant, D),
                     "flops": cost["flops"], "bytes": cost["bytes"],
                     "ms": kern["graph_ms"], "stream_ms": kern["stream_ms"],
                     "plain_ms": plain_t["graph_ms"], "library_ms": lib,
                     "bound_ms": cost["bound_ms"],
                     "bound_by": cost["bound_by"], "bound_term": cost["term"],
                     "bound_terms_ms": cost["terms_ms"],
                     "bound_share": cost["bound_ms"] / kern["graph_ms"],
                     "design_bound_ms": design["bound_ms"],
                     "design_bound_term": design["term"],
                     "sm_clock_mhz": clock}
        del q, k, v
        torch.cuda.empty_cache()
    emit("kernel_time_types", kernel="flash_attention", **out)
    return out


MODEL = "qwen3-4b"
PREFILL_B, PREFILL_S = 2, 4096
# positions whose logits the flash and "ref" prefills must agree on: early
# rows see few keys, so a fault in the causal mask shows there first
POSITIONS = (0, 1, 15, 127, 511, 1023, 2047, 3071, 4094, 4095)
# flash vs "ref" prefill, bf16 compute, largest gap at a position over its
# largest "ref" logit: both round P to bf16 before PV and differ in where
# the rest is rounded, over 36 layers
PREFILL_REL_TOL = 5e-2
# faults planted in the flash call; the check must fail on each
PLANTED = {"causal_false": {"causal": False},
           "window_half": {"window": PREFILL_S // 2}}
# flash prefill vs the decode chain, f32 compute (tests/test_archs.py holds
# the reference to 1e-3 at smoke size)
CONSISTENCY_REL_TOL = 1e-3


class Spy:
    """Wrap `mod.name` for the duration of a `with`: keeps `keep` of what
    it returned, and the device time between CUDA events around each call.
    `force` overrides keyword arguments of every call (a planted fault)."""

    def __init__(self, torch, mod, name, timed=False, keep=lambda out: out,
                 force=None):
        self.torch, self.mod, self.name, self.timed = torch, mod, name, timed
        self.keep, self.force = keep, force or {}
        self.real = getattr(mod, name)
        self.returned, self.events = [], []

    def __enter__(self):
        def spy(*a, **kw):
            if self.timed:
                ev = [self.torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
            out = self.real(*a, **{**kw, **self.force})
            if self.timed:
                ev[1].record()
                self.events.append(ev)
            self.returned.append(self.keep(out))
            return out
        setattr(self.mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)

    def device_s(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def model_params(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import layers, registry

    cfg = get_config(MODEL)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = layers.tree_init(registry.param_defs(cfg), gen)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in layers.tree_items(params))
    emit("model_init", model=MODEL, params=n, bytes=4 * n,
         wall_s=time.perf_counter() - t0)
    return cfg, params


def prefill_tokens(torch, cfg, dev):
    """The prefill's B=2 prompts of 4096 tokens, made from the seed."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    return torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                         device=dev, dtype=torch.int32)


def serve_requests(cfg, lens=(8, 23, 41, 64), max_new=16):
    """The serving wave's requests, prompts made from the seed."""
    import numpy as np

    from repro_torch.train.serve import Request

    rng = np.random.default_rng(SEED)
    return [Request(i, rng.integers(0, cfg.vocab, n).tolist(),
                    max_new=max_new) for i, n in enumerate(lens)]


def logit_gaps(torch, registry, cfg, params, rc, x, x_ref) -> list[float]:
    """At each of POSITIONS: the largest logit gap between two final hidden
    states (B, S, d) over the largest |logit| of `x_ref`."""
    pos = torch.tensor(POSITIONS, device=x.device)
    got = registry.unembed(cfg, params, x[:, pos], rc).float()
    want = registry.unembed(cfg, params, x_ref[:, pos], rc).float()
    err = (got - want).abs().amax(dim=(0, 2))
    return (err / want.abs().amax(dim=(0, 2))).tolist()


def prefill_path(torch, fa, parity, cfg, params, dev, compute="bfloat16",
                 n_runs=2, phase="prefill") -> dict:
    """Main path, prefill: build_prefill_step with attn_impl="flash" on B=2
    prompts of 4096 tokens, `compute` over f32 parameters.  Each of the
    `n_runs` calls (the later ones warm) must launch the flash kernel's
    `wgmma` variant once per layer, in the compute dtype, and the XOR
    kernel never.  Its logits at POSITIONS must agree with the same step
    on attn_impl="ref", whose states must be finite, and the same check
    must fail when a fault is planted in the flash call (PLANTED)."""
    from repro_torch.models import registry
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import build_prefill_step

    tokens = prefill_tokens(torch, cfg, dev)
    rc = RunConfig(seq_len=PREFILL_S, global_batch=PREFILL_B,
                   kind="prefill", attn_impl="flash", compute_dtype=compute)
    step = build_prefill_step(cfg, rc, device=dev)
    hidden = (lambda out: out[0])            # forward's final hidden states
    want_launches = {f"wgmma/{compute}": cfg.n_layers}
    runs = []
    for _ in range(n_runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES = parity.LAUNCHES = 0
        fa.VARIANT_LAUNCHES = dict.fromkeys(fa.VARIANTS, 0)
        fa.DTYPE_LAUNCHES = {}
        with Spy(torch, fa, "flash_attention", timed=True) as flash, \
                Spy(torch, registry, "forward", keep=hidden) as fwd:
            t = time.perf_counter()
            tok, cache = step(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        runs.append({"wall_s": wall, "launches": fa.LAUNCHES,
                     "variant_launches": dict(fa.VARIANT_LAUNCHES),
                     "dtype_launches": dict(fa.DTYPE_LAUNCHES),
                     "xor_launches": parity.LAUNCHES,
                     "flash_device_s": flash.device_s(),
                     "flash_share": flash.device_s() / wall,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        if fa.LAUNCHES != cfg.n_layers or parity.LAUNCHES or \
                fa.DTYPE_LAUNCHES != want_launches:
            raise AssertionError(f"{fa.DTYPE_LAUNCHES} flash and "
                                 f"{parity.LAUNCHES} XOR launches in the "
                                 f"prefill, want {want_launches} and 0")
    x = fwd.returned[0]
    launches = runs[0]["launches"]
    variant_launches = runs[0]["variant_launches"]
    shape_ok = (tuple(tok.shape) == (PREFILL_B, 1) and tuple(
        cache["k"].shape) == (cfg.n_layers, PREFILL_B, PREFILL_S,
                              cfg.n_kv_heads, cfg.head_dim))
    if not shape_ok or not bool(torch.isfinite(x).all()):
        raise AssertionError("prefill: wrong shapes or non-finite states")
    del cache

    # the same step with the plain attention of the reference ("ref")
    ref_step = build_prefill_step(
        cfg, RunConfig(seq_len=PREFILL_S, global_batch=PREFILL_B,
                       kind="prefill", attn_impl="ref",
                       compute_dtype=compute), device=dev)
    torch.cuda.reset_peak_memory_stats()
    with Spy(torch, registry, "forward", keep=hidden) as ref_fwd:
        t = time.perf_counter()
        ref_tok, ref_cache = ref_step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    del ref_cache
    x_ref = ref_fwd.returned[0]
    if not bool(torch.isfinite(x_ref).all()):
        raise AssertionError(f"the \"ref\" prefill in {compute} is not "
                             f"finite at depth {cfg.n_layers}: no reference "
                             f"to hold the flash prefill to")
    gaps = logit_gaps(torch, registry, cfg, params, rc, x, x_ref)

    # the check against planted faults: each must break it
    planted = {}
    for name, force in PLANTED.items():
        with Spy(torch, fa, "flash_attention", force=force), \
                Spy(torch, registry, "forward", keep=hidden) as bad:
            step(params, {"tokens": tokens})
        planted[name] = logit_gaps(torch, registry, cfg, params, rc,
                                   bad.returned[0], x_ref)
    out = {"model": MODEL, "B": PREFILL_B, "S": PREFILL_S,
           "compute": compute, "launches": launches,
           "variant_launches": variant_launches,
           "dtype_launches": runs[0]["dtype_launches"], "runs": runs,
           "next_tokens": tok.reshape(-1).tolist(),
           "ref_next_tokens": ref_tok.reshape(-1).tolist(),
           "positions": POSITIONS, "rel_gaps": gaps,
           "tolerance_rel": PREFILL_REL_TOL, "planted_rel_gaps": planted,
           "ref_wall_s": ref_wall, "ref_peak_gib": ref_peak}
    emit(phase, **out)
    if not max(gaps) <= PREFILL_REL_TOL:
        raise AssertionError(f"flash prefill logits ({compute}) differ from "
                             f"ref: {gaps} > {PREFILL_REL_TOL}")
    for name, bad in planted.items():
        if max(bad) <= PREFILL_REL_TOL:
            raise AssertionError(f"the prefill check ({compute}) passes the "
                                 f"planted fault {name}: {bad}")
    return out


def consistency_check(torch, cfg, params, dev,
                      phase="prefill_decode_consistency") -> dict:
    """f32 compute: the flash prefill's last-position logits of two
    64-token prompts against the decode chain's logits at position 63."""
    from repro_torch.models import registry
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import build_prefill_step

    S = 64
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab, (2, S), generator=gen, device=dev,
                           dtype=torch.int32)
    rc = RunConfig(seq_len=S, global_batch=2, kind="prefill",
                   attn_impl="flash", compute_dtype="float32")
    with Spy(torch, registry, "unembed") as head:
        build_prefill_step(cfg, rc, device=dev)(params, {"tokens": tokens})
    want = head.returned[0][:, 0].float()
    drc = RunConfig(seq_len=S, global_batch=2, kind="decode",
                    attn_impl="ref", compute_dtype="float32")
    spec = registry.init_cache(cfg, 2, S, torch.float32)
    cache = {k: torch.zeros(s, dtype=dt, device=dev)
             for k, (s, dt) in spec.items()}
    with torch.no_grad():
        for t in range(S):
            got, cache = registry.decode(cfg, params, cache,
                                         tokens[:, t:t + 1], t, drc)
    got = got[:, 0].float()
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    out = {"S": S, "compute": "float32", "max_abs_err": err,
           "logits_max_abs": float(want.abs().max()),
           "tolerance": CONSISTENCY_REL_TOL * scale,
           "argmax_equal": bool(torch.equal(got.argmax(-1),
                                            want.argmax(-1)))}
    emit(phase, **out)
    if not err <= CONSISTENCY_REL_TOL * scale:
        raise AssertionError(f"decode chain differs from the flash prefill: "
                             f"{err}")
    return out


def serve_path(torch, fa, parity, cfg, params, tag="", device="cuda"
               ) -> dict:
    """Main path, serving: BatchedServer on the card answers 4 requests
    with prompts of 8-64 tokens, 16 new tokens each."""
    from repro_torch.train.serve import BatchedServer

    cuda = torch.device(device).type == "cuda"
    reqs = serve_requests(cfg)
    lens = [len(r.prompt) for r in reqs]
    srv = BatchedServer(cfg, params, max_seq=256, device=device)
    fa.LAUNCHES = parity.LAUNCHES = 0
    sync(torch, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = srv.generate(reqs)
    sync(torch, device)
    wall = time.perf_counter() - t
    steps = max(lens) + 16 - 1        # lockstep prompt + 15 decode steps
    res = {"requests": len(out), "prompt_lens": lens,
           "tokens_out": sum(len(r.out) for r in out), "decode_steps": steps,
           "wall_s": wall, "wall_ms_per_step": wall / steps * 1e3,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if cuda
                        else None),
           "flash_launches": fa.LAUNCHES, "xor_launches": parity.LAUNCHES,
           "outs": [r.out for r in out]}
    emit(tag + "serve", **res)
    if [len(r.out) for r in out] != [16] * 4 or not all(
            0 <= t < cfg.vocab for r in out for t in r.out):
        raise AssertionError("serve: a request did not get 16 valid tokens")
    if fa.LAUNCHES or parity.LAUNCHES:        # decode runs on "ref"
        raise AssertionError("serve: a kernel launched on the serving path")
    return res


# ------------------------------------------------------------- training

# phase 12: qwen3-4b at full width and vocabulary, depth cut 36 -> 2 (4.41 G
# parameters would need 70.6 GB of f32 parameters, gradients and moments);
# the repo's train_4k shape with its global batch cut 256 -> 4 and its 4
# microbatches kept (one 4096-token sequence each)
TRAIN_LAYERS = 2
TRAIN_BATCH = 4
TRAIN_STEPS = 3
TRAIN_FAIL_AT = 2            # ost1 fails before the third step
AFTER_RESUME_STEPS = 2       # steps of each trainer compared after resume
# the Trainer stripes each checkpoint leaf over min(3, osts) OSTs in
# 256 KiB units; the parity call of a leaf XORs one row per OST
TRAIN_STRIPES, TRAIN_STRIPE_SIZE = 3, 1 << 18
# card vs CPU: the same two f32 train steps of B=1 x 64 tokens
TRAIN_CONSISTENCY_S = 64
TRAIN_CONSISTENCY_REL = 1e-4


def train_config():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import SHAPES
    from repro_torch.train.trainer import TrainerConfig

    return TrainerConfig(
        model=get_config(MODEL).scaled(n_layers=TRAIN_LAYERS),
        rc=dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH),
        n_writers=2, parity=True, dataset_seqs=64, ckpt_every=3, seed=SEED)


def leaf_row_lanes(nbytes: int) -> int:
    """N of the parity call of a checkpoint leaf of `nbytes`: its longest
    row (stripe 0's columns) in int32 lanes, padded to 16 bytes as
    ops.parity_bytes pads it."""
    cols = -(-nbytes // TRAIN_STRIPE_SIZE)
    row = sum(min(TRAIN_STRIPE_SIZE, nbytes - c * TRAIN_STRIPE_SIZE)
              for c in range(0, cols, TRAIN_STRIPES))
    return -(-row // 16) * 4


class ParityCalls:
    """Wrap ops.parity_bytes for a `with` (the checkpoint's only way to
    the kernel: reconstruct_bytes calls it too): K, N lanes and host ms
    of each call."""

    def __init__(self, ops):
        self.ops, self.real, self.calls = ops, ops.parity_bytes, []

    def __enter__(self):
        def timed(chunks, *, device):
            t = time.perf_counter()
            out = self.real(chunks, device=device)
            self.calls.append({
                "K": len(chunks), "N": -(-max(map(len, chunks)) // 16) * 4,
                "ms": (time.perf_counter() - t) * 1e3, "bytes": len(out)})
            return out
        self.ops.parity_bytes = timed
        return self

    def __exit__(self, *exc):
        self.ops.parity_bytes = self.real

    def summary(self) -> dict:
        return {"calls": len(self.calls),
                "s": sum(c["ms"] for c in self.calls) / 1e3,
                "largest": max(self.calls, key=lambda c: (c["K"] * c["N"],
                                                          c["ms"]),
                               default=None)}


def drop_stripe(cluster, fs, path, slot):
    """Lose one stripe object of `path` (a dead OST disk), as
    tests/test_ckpt.py does."""
    ea = fs.lmv.getattr(fs.resolve(path), want_ea=True)["ea"]["lov"]
    victim = ea["objects"][slot]
    tgt = next(x for x in cluster.ost_targets if x.uuid == victim["ost"])
    tgt.obd.objects.pop((victim["group"], victim["oid"]))
    return victim["ost"]


def host_peak_gib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def train_path(torch, fa, parity, ops, dev, tcfg,
               lost=("params.embed.bin", 1), tag="") -> dict:
    """Phase 12, the main path of training: Trainer(cluster, cfg).run(3)
    with ost1 failing before the third step, the parity-coded checkpoint
    at step 3 (one kernel launch a leaf), one stripe object of
    params.embed lost, Trainer.resume (one more launch, the stripe rebuilt
    on the card), the restored state equal to the saved one byte for byte,
    and AFTER_RESUME_STEPS more steps of each trainer on the same batches
    with bit-equal losses: the second step also holds the first step's
    update (its backward, the embedding's included) to be deterministic.
    `lost` names the leaf file and the stripe slot whose object is lost;
    `tag` prefixes the phase names."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import LustreCluster
    from repro_torch.models.layers import tree_items
    from repro_torch.train.trainer import Trainer

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rc = tcfg.rc
    # the reference's own knob: no OSC clean cache (ROADMAP R8)
    cluster = LustreCluster(osts=4, mdses=1, clients=2, ost_failover=True,
                            commit_interval=64, device=dev, max_cached_mb=0)
    t0 = time.perf_counter()
    tr = Trainer(cluster, tcfg)
    tr.init_state()
    sync()
    n_params = sum(t.numel() for _, t in tree_items(tr.params))
    emit(tag + "train_setup", model=tcfg.model.name, layers=tcfg.model.n_layers,
         params=n_params, seq_len=rc.seq_len, global_batch=rc.global_batch,
         num_microbatches=rc.num_microbatches, remat=rc.remat,
         compute=rc.compute_dtype, attn_impl=rc.attn_impl,
         wall_s=time.perf_counter() - t0)

    step_s, saves = [], []
    real_step, real_save = tr.step_fn, tr.ckpt.save

    def timed_step(*a):
        sync()
        t = time.perf_counter()
        out = real_step(*a)
        sync()
        step_s.append(time.perf_counter() - t)
        return out

    def timed_save(step, tree, **kw):
        launched, t = parity.LAUNCHES, time.perf_counter()
        with ParityCalls(ops) as calls:
            m = real_save(step, tree, **kw)
        saves.append({"wall_s": time.perf_counter() - t,
                      "launches": parity.LAUNCHES - launched,
                      "manifest": m, "parity": calls.summary(),
                      "parity_bytes": sum(c["bytes"] for c in calls.calls)})
        return m

    tr.step_fn, tr.ckpt.save = timed_step, timed_save
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    parity.LAUNCHES = fa.LAUNCHES = 0
    t = time.perf_counter()
    metrics = tr.run(TRAIN_STEPS, fail_at={
        TRAIN_FAIL_AT: lambda c: c.fail_node("ost1")})
    run_s = time.perf_counter() - t
    run_launches, run_flash = parity.LAUNCHES, fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    vtime_run = cluster.now
    save = saves[0] if len(saves) == 1 else None
    leaves = save["manifest"]["leaves"] if save else {}
    with_parity = sum(1 for e in leaves.values() if e.get("parity"))
    warm = statistics.median(step_s[1:])
    tokens = rc.global_batch * rc.seq_len
    out = {"metrics": metrics, "step_s": step_s, "warm_step_s": warm,
           "tokens_per_step": tokens, "tokens_per_s": tokens / warm,
           "peak_gib": peak, "run_wall_s": run_s, "launches": run_launches,
           "flash_launches": run_flash, "vtime_s": vtime_run,
           "ckpt_steps": tr.ckpt.steps(), "leaves": len(leaves),
           "leaves_with_parity": with_parity,
           "host_peak_gib_so_far": host_peak_gib()}
    if save:
        out["save"] = {"wall_s": save["wall_s"],
                       "launches": save["launches"],
                       "data_bytes": sum(e["bytes"] for e in leaves.values()),
                       "parity_bytes": save["parity_bytes"],
                       "parity_call_s": save["parity"]["s"],
                       "parity_calls": save["parity"]["calls"],
                       "largest_call": save["parity"]["largest"]}
    emit(tag + "train_run", **out)
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics) or len(metrics) != TRAIN_STEPS:
        raise AssertionError(f"train: non-finite or missing metrics "
                             f"{metrics}")
    if run_flash:
        raise AssertionError(f"train: {run_flash} flash launches")
    if out["ckpt_steps"] != [TRAIN_STEPS] or save is None:
        raise AssertionError(f"train: checkpoints {out['ckpt_steps']}, "
                             f"{len(saves)} saves")
    if cuda and not (run_launches == save["launches"] == with_parity
                     == save["parity"]["calls"] > 0):
        raise AssertionError(f"train: {run_launches} launches in the run, "
                             f"{save['launches']} in the save, for "
                             f"{with_parity} leaves with parity")

    # one stripe object of the embedding's file is lost
    base = f"{tcfg.ckpt_base}/step_{TRAIN_STEPS:08d}"
    lost_on = drop_stripe(cluster, tr.fs, f"{base}/{lost[0]}", lost[1])
    rebuilt0 = cluster.stats.counters.get("ckpt.stripe_reconstructed", 0)
    restore_s = []
    real_restore = CheckpointManager.restore

    def timed_restore(self, *a, **kw):
        t1 = time.perf_counter()
        try:
            return real_restore(self, *a, **kw)
        finally:
            restore_s.append(time.perf_counter() - t1)

    parity.LAUNCHES = fa.LAUNCHES = 0
    t = time.perf_counter()
    CheckpointManager.restore = timed_restore
    try:
        with ParityCalls(ops) as calls:
            tr2 = Trainer.resume(cluster, tcfg)
            sync()
    finally:
        CheckpointManager.restore = real_restore
    resume_s = time.perf_counter() - t
    resume_launches = parity.LAUNCHES
    rebuilt = cluster.stats.counters.get("ckpt.stripe_reconstructed",
                                         0) - rebuilt0
    saved = dict(tree_items({"params": tr.params, "opt": tr.opt_state}))
    restored = dict(tree_items({"params": tr2.params,
                                "opt": tr2.opt_state}))
    differ = [".".join(k) for k in saved if k not in restored
              or saved[k].dtype != restored[k].dtype
              or saved[k].shape != restored[k].shape
              or not torch.equal(saved[k], restored[k])]
    differ += [".".join(k) for k in restored if k not in saved]
    res = {"wall_s": resume_s, "restore_s": restore_s[0],
           "launches": resume_launches, "stripe_reconstructed": rebuilt,
           "lost_stripe_on": lost_on, "parity": calls.summary(),
           "leaves_compared": len(saved), "leaves_differ": differ,
           "step": tr2.step, "vtime_s": cluster.now - vtime_run,
           "host_peak_gib_so_far": host_peak_gib()}
    emit(tag + "train_resume", **res)
    if rebuilt != 1 or differ or tr2.step != TRAIN_STEPS or (
            cuda and resume_launches != 1) or calls.summary()["calls"] != 1:
        raise AssertionError(f"train resume: {res}")

    # each trainer takes the same steps on the same batches
    losses = []
    for trainer in (tr, tr2):
        losses.append([])
        for i in range(AFTER_RESUME_STEPS):
            trainer.params, trainer.opt_state, m = trainer.step_fn(
                trainer.params, trainer.opt_state,
                trainer._batch(trainer.step + i))
            losses[-1].append(float(m["loss"]))
    after = {"steps": AFTER_RESUME_STEPS, "losses": losses,
             "equal": losses[0] == losses[1]}
    emit(tag + "train_after_resume", **after)
    if losses[0] != losses[1]:
        raise AssertionError(f"train: losses after resume differ {losses}")
    out.update(resume=res, after_resume=after, host_peak_gib=host_peak_gib())
    return out


def train_consistency(torch, model, dev, repeat=False,
                      phase="train_consistency") -> dict:
    """The same two train steps of `model` on the card and on the CPU (the
    named reference of this check), f32 compute, on B=1 x 64 tokens from
    the seed, from one initial state made on the card: loss and grad_norm
    of each step within TRAIN_CONSISTENCY_REL relative.  With `repeat`
    the card runs the two steps twice from that state, and the two runs'
    losses, grad norms and updated parameters must be equal bit for
    bit."""
    import numpy as np

    from repro_torch.models import layers, registry
    from repro_torch.models.config import RunConfig
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_train_step

    S = TRAIN_CONSISTENCY_S
    rc = RunConfig(seq_len=S, global_batch=1, kind="train",
                   compute_dtype="float32")
    rng = np.random.default_rng(SEED + 3)
    batches = []
    for _ in range(2):
        toks = rng.integers(0, model.vocab, (1, S), dtype=np.int32)
        lab = np.roll(toks, -1, axis=-1)
        lab[:, -1] = 0
        batches.append({"tokens": toks, "labels": lab})
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    card = layers.tree_init(registry.param_defs(model), gen)
    host = layers.tree_map(lambda t: t.to("cpu", copy=True), card)
    runs, again = {}, None
    order = (("card", dev),) + ((("card_repeat", dev),) if repeat else ()) \
        + (("cpu", "cpu"),)
    for name, where in order:
        if name == "card_repeat":        # from the untouched host copy
            again = layers.tree_map(lambda t: t.to(dev, copy=True), host)
        params = {"card": card, "card_repeat": again, "cpu": host}[name]
        step = build_train_step(model, rc, device=where)
        state = adamw.init_state(params)
        t = time.perf_counter()
        rows = []
        for b in batches:
            params, state, m = step(params, state, {
                k: torch.from_numpy(v) for k, v in b.items()})
            rows.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"])})
        runs[name] = {"steps": rows, "wall_s": time.perf_counter() - t}
        del params, state
    # after the two updates (in place): each leaf's largest gap over its
    # largest value, as a yardstick of how far the two devices' sums part
    param_gaps = {".".join(k): float((a.cpu() - host_t).abs().max()
                                     / host_t.abs().max().clamp_min(1e-30))
                  for (k, a), (_, host_t) in zip(layers.tree_items(card),
                                                 layers.tree_items(host))}
    bit_equal = None
    if repeat:
        bit_equal = runs["card"]["steps"] == runs["card_repeat"]["steps"] \
            and all(torch.equal(a, b) for (_, a), (_, b) in zip(
                layers.tree_items(card), layers.tree_items(again)))
    card = host = again = None
    gaps = [max(abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm"))
            for a, b in zip(runs["card"]["steps"], runs["cpu"]["steps"])]
    out = {"model": model.name, "layers": model.n_layers, "S": S, "B": 1,
           "compute": "float32", "runs": runs, "rel_gaps": gaps,
           "tolerance_rel": TRAIN_CONSISTENCY_REL,
           "repeat_bit_equal": bit_equal, "param_rel_gaps": param_gaps,
           "host_peak_gib_so_far": host_peak_gib()}
    emit(phase, **out)
    if repeat and not bit_equal:
        raise AssertionError("two runs of the train step on the card from "
                             "one state differ")
    if not max(gaps) <= TRAIN_CONSISTENCY_REL:
        raise AssertionError(f"train step on the card differs from the CPU:"
                             f" {gaps}")
    return out


def main_path(device, mib: int, ops, parity) -> dict:
    """Phase 5 (and its rehearsal on the CPU at a small `mib`)."""
    import numpy as np

    from repro_torch.core import LustreCluster
    from repro_torch.fsio import LustreClient

    size = mib << 20
    t0 = time.perf_counter()
    data = np.random.default_rng(SEED).bytes(size)
    c = LustreCluster(osts=5, mdses=1, clients=3, spare_osts=1,
                      device=device)
    fs = LustreClient(c, 0).mount()
    emit("main_setup", device=str(c.device), mib=mib,
         wall_s=time.perf_counter() - t0)

    calls = {"n": 0, "s": 0.0}
    real_parity_bytes = ops.parity_bytes

    def counted(chunks, *, device):           # the LOV's only way in
        t = time.perf_counter()
        try:
            return real_parity_bytes(chunks, device=device)
        finally:
            calls["n"] += 1
            calls["s"] += time.perf_counter() - t

    def lov():
        return {k: v for k, v in c.stats.counters.items()
                if k.startswith("lov.")}

    def cold_read(idx, length):
        r = LustreClient(c, idx).mount()
        f = r.open("/f")
        got = r.read(f, length, offset=0)
        r.close(f)
        return got

    steps = []

    def step(name, fn, expect_calls):
        before_lov, before_calls = lov(), calls["n"]
        before_launch, before_s = parity.LAUNCHES, calls["s"]
        vt0, t = c.now, time.perf_counter()
        ok = fn()
        wall = time.perf_counter() - t
        delta = {k: v - before_lov.get(k, 0) for k, v in lov().items()
                 if v != before_lov.get(k, 0)}
        made = calls["n"] - before_calls
        launched = parity.LAUNCHES - before_launch
        want = expect_calls(delta)
        rec = {"step": name, "ok": ok, "wall_s": wall,
               "parity_call_s": calls["s"] - before_s,
               "ms_per_call": (calls["s"] - before_s) / max(made, 1) * 1e3,
               "vtime_s": c.now - vt0, "lov_calls": made,
               "expected_lov_calls": want, "launches": launched,
               "lov_counters": delta}
        emit("main_step", **rec)
        steps.append(rec)
        if not ok:
            raise AssertionError(f"main path step {name}: bytes differ")
        if made != want:
            raise AssertionError(f"{name}: {made} parity calls, the LOV "
                                 f"counters say {want}")
        if device != "cpu" and launched != made:
            raise AssertionError(f"{name}: {launched} launches for {made} "
                                 "parity calls")

    def write():
        fh = fs.creat("/f", stripe_count=4, stripe_size=STRIPE,
                      pattern="raid5")
        fs.write(fh, data, offset=0)
        fs.close(fh)
        for t in c.ost_targets:
            t.commit()
        return fs.stat("/f")["size"] == size

    def rebuild():
        rep = c.lctl("rebuild", "OST0001", c.spare_uuids[0])
        return rep["rebuilt"] == 1 and rep["swapped"] == 1

    cut = size // 2 + 12345                       # not stripe-aligned

    def truncate():
        fs.truncate("/f", cut)
        return fs.stat("/f")["size"] == cut

    recon = (lambda d: d.get("lov.reconstruct_unit", 0))
    ops.parity_bytes = counted
    try:
        # one parity call per full 4 MiB round on write
        step("write", write, lambda d: d.get("lov.parity_bytes", 0) // STRIPE)
        step("clean_read", lambda: cold_read(1, size) == data, recon)
        c.fail_node("ost1")
        step("degraded_read", lambda: cold_read(2, size) == data, recon)
        step("rebuild", rebuild, recon)
        step("read_after_rebuild", lambda: cold_read(1, size) == data, recon)
        # the new tail round's parity is recomputed once
        step("truncate", truncate, lambda d: 1 + recon(d))
        step("read_truncated", lambda: cold_read(2, cut) == data[:cut],
             recon)
    finally:
        ops.parity_bytes = real_parity_bytes
    total_calls = sum(s["lov_calls"] for s in steps)
    summary = {"mib": mib, "vtime_s": c.now, "lov_calls": total_calls,
               "wall_s": sum(s["wall_s"] for s in steps),
               "parity_call_s": sum(s["parity_call_s"] for s in steps),
               "lov_counters": lov()}
    emit("main_path", **summary)
    return summary


def fresh_ids(first_uuid: int = 0):
    """Start the simulator's process-wide id sequences as a fresh process
    starts them, client uuids at `first_uuid`.  Client uuids are strings
    whose length the wire-size model counts, so virtual times depend on
    how many clients the process made before (ROADMAP R6)."""
    import itertools

    from repro_torch.core import dlm, llog, ptlrpc

    ptlrpc.RpcClient._uuid_seq = itertools.count(first_uuid)
    ptlrpc._trace_seq = itertools.count(1)
    dlm._handle_seq = itertools.count(1)
    llog._cookie_seq = itertools.count(1)


def bench_raid5(device, parity) -> dict:
    """Phase 6: the raid5 section of BENCH_rpc.json, parity on `device`.
    BENCH_rpc.json was written after other benchmarks had made clients
    (two-digit uuid numbers), so the sequences start there."""
    from repro_torch.tools.raid5_metrics import raid5_metrics

    want = json.loads((ROOT / "BENCH_rpc.json").read_text())["raid5"]
    want.pop("regressed", None)
    fresh_ids(10)
    launches = parity.LAUNCHES
    t0 = time.perf_counter()
    got = raid5_metrics(device=device)
    emit("bench_raid5", equal=got == want, wall_s=time.perf_counter() - t0,
         launches=parity.LAUNCHES - launches, got=got)
    if got != want:
        raise AssertionError(f"raid5 section differs: {got} != {want}")
    return got


# ------------------------------------------------------- entry points

# phase 13: serve_batched on the card against the CPU, f32 compute from one
# initial state: the same tolerance as phase 12's card/CPU check (the two
# devices sum in other orders; 10 steps of a 2-layer model stay far inside)
ENTRY_SERVE_REL = TRAIN_CONSISTENCY_REL
# train_e2e at --large and the example's defaults (200 steps of 8 x 128)
ENTRY_E2E_ARGS = ["--large"]


def start_module(module: str, *args: str) -> subprocess.Popen:
    """`python -m module args` in a fresh process (fresh id sequences),
    its standard output piped."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, timeout=600) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    if proc.returncode:
        raise AssertionError(f"{proc.args} exited {proc.returncode}: "
                             f"{err[-2000:]}")
    return out


def captured(fn, *a, **kw) -> tuple[object, str]:
    """fn(*a, **kw) with the simulator's id sequences started afresh, as
    in a fresh process; returns its result and its standard output."""
    import contextlib
    import io

    fresh_ids()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def entry_points(torch, parity, ops, dev) -> dict:
    """Phase 13: the port's examples and benchmarks as a user runs them,
    on the card (`dev`; the CPU in a rehearsal, where no launch is
    counted); each kernel launch counted around its own entry point."""
    from repro_torch.examples import failover_demo
    from repro_torch.tools import bench_checkpoint, bench_parity

    where = torch.device(dev).type
    cuda = where == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # quickstart on the card and on the CPU, and failover_demo on the CPU:
    # fresh processes, run beside the in-process work below
    procs = {"quickstart_card": start_module(
                 "repro_torch.examples.quickstart", "--device", where),
             "quickstart_cpu": start_module(
                 "repro_torch.examples.quickstart", "--device", "cpu"),
             "failover_demo_cpu": start_module(
                 "repro_torch.examples.failover_demo", "--device", "cpu")}
    res = {}
    try:
        # failover_demo on the card, in this process to count launches
        parity.LAUNCHES = 0
        t = time.perf_counter()
        with ParityCalls(ops) as calls:
            _, card = captured(failover_demo.main, ["--device", where])
        launches = parity.LAUNCHES
        cpu = finish(procs.pop("failover_demo_cpu"))
        res["failover_demo"] = rec = {
            "wall_s": time.perf_counter() - t, "lines": len(card.splitlines()),
            "equal_cpu": card == cpu, "launches": launches,
            "parity_calls": calls.summary()["calls"]}
        emit("entry", name="failover_demo", **rec)
        if card != cpu or rec["parity_calls"] != 1 or (
                cuda and launches != 1):
            raise AssertionError(f"failover_demo: {rec}\n{card}\n{cpu}")

        res["serve_batched"] = entry_serve(torch, parity, dev)
        res["bench_checkpoint"] = entry_bench_checkpoint(
            torch, parity, ops, bench_checkpoint, where)
        rows = bench_parity.kernel_half(dev)
        res["bench_parity"] = {str(k): r for k, r in rows.items()}
        emit("entry", name="bench_parity", rows=res["bench_parity"])

        card, cpu = (finish(procs.pop(k))
                     for k in ("quickstart_card", "quickstart_cpu"))
        res["quickstart"] = rec = {"lines": len(card.splitlines()),
                                   "equal_cpu": card == cpu}
        emit("entry", name="quickstart", **rec)
        if card != cpu:
            raise AssertionError(f"quickstart: card\n{card}\ncpu\n{cpu}")

        res["train_e2e"] = entry_train_e2e(torch, parity, ops, where)
    finally:
        for p in procs.values():
            p.kill()
    res["launches"] = sum(res[k]["launches"] for k in (
        "failover_demo", "bench_checkpoint", "train_e2e"))
    emit("entry_points", launches=res["launches"],
         host_peak_gib=host_peak_gib())
    return res


def entry_serve(torch, parity, dev) -> dict:
    """serve_batched on the card and on the CPU, f32 compute, from one
    initial state made on the CPU from the seed."""
    from repro_torch.examples import serve_batched
    from repro_torch.models import convert, layers, registry
    from repro_torch.optim import adamw

    cfg = serve_batched.trainer_config("float32")
    params = layers.tree_init(registry.param_defs(cfg.model),
                              torch.Generator().manual_seed(SEED))
    state = convert.state_to_numpy(params, adamw.init_state(params))
    runs = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        parity.LAUNCHES = 0
        t = time.perf_counter()
        runs[name], _ = captured(serve_batched.run, where,
                                 compute_dtype="float32", state=state)
        runs[name].update(wall_s=time.perf_counter() - t,
                          launches=parity.LAUNCHES)
    card, cpu = runs["card"], runs["cpu"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                cpu["losses"])]
    rec = {"outs": [r["out"] for r in card["outs"]],
           "weights_kib": card["weights_kib"],
           "weights_kib_cpu": cpu["weights_kib"],
           "losses": card["losses"], "loss_rel_gaps": gaps,
           "tolerance_rel": ENTRY_SERVE_REL,
           "tokens_equal_cpu": card["outs"] == cpu["outs"],
           "ckpt_steps": card["ckpt_steps"], "wall_s": card["wall_s"],
           "cpu_wall_s": cpu["wall_s"], "launches": card["launches"]}
    emit("entry", name="serve_batched", **rec)
    if card["weights_kib"] != cpu["weights_kib"] or len(gaps) != 10 or \
            not max(gaps) <= ENTRY_SERVE_REL or card["launches"] or \
            [len(r["out"]) for r in card["outs"]] != [8] * 4:
        raise AssertionError(f"serve_batched: {rec}")
    return rec


def entry_bench_checkpoint(torch, parity, ops, bench, card) -> dict:
    """bench_checkpoint on the card equals its CPU run (virtual-time MB/s
    do not depend on the device); the parity row launches the kernel once
    a leaf."""
    runs = {}
    for where in (card, "cpu"):
        parity.LAUNCHES = 0
        t = time.perf_counter()
        with ParityCalls(ops) as calls:
            runs[where], _ = captured(bench.run, where)
        runs[where + "_launches"] = parity.LAUNCHES
        runs[where + "_calls"] = calls.summary()["calls"]
        runs[where + "_wall_s"] = time.perf_counter() - t
    n_leaves = len(bench.state())
    rec = {"equal_cpu": runs[card] == runs["cpu"], "rows": runs[card],
           "launches": runs[card + "_launches"],
           "parity_calls": runs[card + "_calls"], "leaves": n_leaves,
           "wall_s": runs[card + "_wall_s"], "cpu_wall_s": runs["cpu_wall_s"]}
    emit("entry", name="bench_checkpoint", **rec)
    if not rec["equal_cpu"] or rec["parity_calls"] != n_leaves or (
            card == "cuda" and rec["launches"] != n_leaves):
        raise AssertionError(f"bench_checkpoint: {rec} cpu {runs['cpu']}")
    return rec


def entry_train_e2e(torch, parity, ops, where) -> dict:
    """train_e2e --large on the card at the example's defaults: every
    loss finite and the last below the first, the expected checkpoints,
    the resume at the last checkpoint at or before half, and one kernel
    launch per parity call (one a leaf a save, plus any rebuild).  Times
    its steps, saves and resume."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.examples import train_e2e
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.trainer import Trainer

    args = train_e2e.parse_args(ENTRY_E2E_ARGS)
    step_s, saves, resumes = [], [], []
    real_build, real_save = steps_mod.build_train_step, CheckpointManager.save
    real_resume = Trainer.resume.__func__

    cuda = where == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def timed_build(*a, **kw):
        fn = real_build(*a, **kw)
        step_s.append([])

        def step(*sa):
            sync()
            t = time.perf_counter()
            out = fn(*sa)
            sync()
            step_s[-1].append(time.perf_counter() - t)
            return out
        return step

    def timed_save(self, step, tree, **kw):
        t = time.perf_counter()
        m = real_save(self, step, tree, **kw)
        saves.append({"step": step, "wall_s": time.perf_counter() - t,
                      "leaves_with_parity": sum(
                          1 for e in m["leaves"].values() if e.get("parity"))})
        return m

    def timed_resume(cls, *a, **kw):
        t = time.perf_counter()
        tr = real_resume(cls, *a, **kw)
        resumes.append(time.perf_counter() - t)
        return tr

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    parity.LAUNCHES = 0
    steps_mod.build_train_step = timed_build
    CheckpointManager.save = timed_save
    Trainer.resume = classmethod(timed_resume)
    try:
        with ParityCalls(ops) as calls:
            r, printed = captured(train_e2e.main,
                                  ENTRY_E2E_ARGS + ["--device", where])
    finally:
        steps_mod.build_train_step = real_build
        CheckpointManager.save = real_save
        Trainer.resume = classmethod(real_resume)
    launches = parity.LAUNCHES
    every = max(10, args.steps // 10)
    half = args.steps // 2
    first_run = sorted({*range(every, half + 1, every), half})
    want_ckpts = sorted({*first_run, *range(first_run[-1] + every,
                                            args.steps + 1, every),
                         args.steps})
    warm = statistics.median([t for run in step_s for t in run[1:]])
    tokens = args.batch * args.seq
    losses = r["losses_first"] + r["losses_after"]
    rebuilt = calls.summary()["calls"] - sum(s["leaves_with_parity"]
                                             for s in saves)
    rec = {"model": r["model"], "params": r["params"], "steps": args.steps,
           "batch": args.batch, "seq": args.seq,
           "loss_first": losses[0], "loss_last": losses[-1],
           "checkpoints": r["ckpt_steps"], "resumed_at": r["resumed_at"],
           "wall_s": r["wall_s"], "first_step_s": [run[0] for run in step_s],
           "warm_step_s": warm, "tokens_per_s": tokens / warm,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if cuda else None),
           "save_s": [s["wall_s"] for s in saves], "resume_s": resumes,
           "vtime_s": r["vtime_s"], "launches": launches,
           "parity_calls": calls.summary()["calls"],
           "leaves_with_parity": [s["leaves_with_parity"] for s in saves],
           "rebuilt": rebuilt, "storage": printed.strip().splitlines()[-1],
           "wrote_mib": r["wrote_mib"], "read_mib": r["read_mib"],
           "timeouts": r["timeouts"], "replays": r["replays"],
           "host_peak_gib_so_far": host_peak_gib()}
    emit("entry", name="train_e2e", **rec)
    if not all(math.isfinite(x) for x in losses) or len(losses) != \
            args.steps or not losses[-1] < losses[0]:
        raise AssertionError(f"train_e2e: losses {losses}")
    if r["ckpt_steps"] != want_ckpts or r["resumed_at"] != first_run[-1]:
        raise AssertionError(f"train_e2e: checkpoints {r['ckpt_steps']}, "
                             f"resumed at {r['resumed_at']}, want "
                             f"{want_ckpts} and {first_run[-1]}")
    if rec["parity_calls"] < 1 or rebuilt < 0 or (
            cuda and launches != rec["parity_calls"]):
        raise AssertionError(f"train_e2e: {launches} launches for "
                             f"{rec['parity_calls']} parity calls, "
                             f"{rec['leaves_with_parity']} leaves saved")
    return rec


# ------------------------------------------- phases 14 and 15: families

# phase 14: phi3.5-moe at full width (d 4096, 32/8 heads of 128, 16
# experts top-2 of d_ff 6400, vocab 32064), depth cut 32 -> 4: a layer
# holds 1.30 G parameters, so 32 layers would be 168 GB in f32 (84 GB in
# bf16); 4 layers with the embedding and head are 5.46 G, 21.9 GB in f32
MOE_MODEL, MOE_LAYERS = "phi3.5-moe", 4
# flash vs "ref" prefill, bf16: in bf16 the two attention paths round
# differently, so a few routing decisions flip (a token near a tie between
# two experts).  Held: at least MOE_AGREE_MIN of the checked positions
# routed alike in every layer, and at those positions the largest logit
# gap within PREFILL_REL_TOL of the largest logit (phase 9's limit, for
# the same rounding of the same attention)
MOE_AGREE_MIN = 0.9
# card vs CPU, f32 compute at depth <= 2 (MoE depth 1) and <= 64 tokens:
# the largest logit gap over the largest logit, and aux relative
FAMILY_REL_TOL = 1e-4
AUX_REL_TOL = 1e-5
FAMILY_CPU_S = 64
# phase 15, (arch, layers (None: the whole model), B, S, the K3 launches of
# its bf16 prefill on attn_impl="flash" by variant, layers of its
# card/CPU check).  whisper's decoder runs 384 tokens: the flash entry
# needs S to be a multiple of its 128-row blocks (the reference's
# contract), and 384 is the longest such length within whisper's 448
# positions.  zamba2's check holds one group and one tail block (7), the
# least depth with every kind of block
FAMILY_RUNS = (
    ("dbrx-132b", 1, 2, 4096, {"wgmma": 1}, 1),
    ("whisper-tiny", None, 2, 384, {"wgmma": 4}, 4),
    ("paligemma-3b", None, 2, 256, {}, 2),
    ("gemma3-12b", 6, 1, 2048, {}, 2),
    ("rwkv6-3b", None, 1, 1024, {}, 2),
    ("zamba2-7b", None, 2, 4096, {"wgmma": 13}, 7),
)
# decode steps checked against a prefill (whisper, rwkv6), and gemma3's
# windowed-cache decode: 1,100 steps, past its 1024-slot rings
CONTINUE_STEPS = 16
RING_STEPS = 1100


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def free(torch, dev):
    """Give back what the last model left on the card."""
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def family_params(torch, cfg, dev, seed=SEED):
    """Random f32 parameters of `cfg` on `dev`, from `seed`."""
    from repro_torch.models import layers, registry

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = layers.tree_init(registry.param_defs(cfg), gen)
    sync(torch, dev)
    return params


def n_params(params) -> int:
    from repro_torch.models.layers import tree_items
    return sum(t.numel() for _, t in tree_items(params))


def routing_agreement(torch, got, want) -> tuple[float, object]:
    """Per-layer top-k experts (T, k) of two runs: the share of (token,
    slot) assignments that differ (each token's experts as a set), and
    a (T,) mask of the tokens routed alike in every layer."""
    differ, total, alike = 0, 0, None
    for a, b in zip(got, want, strict=True):
        d = a.sort(dim=-1).values != b.sort(dim=-1).values
        differ += int(d.sum())
        total += d.numel()
        same = ~d.any(dim=-1)
        alike = same if alike is None else alike & same
    return differ / max(total, 1), alike


def check_positions(S) -> list[int]:
    """Every 64th position of S, and the first and last few."""
    return sorted(set(range(0, S, max(1, S // 64))) | {1, 15, S - 2, S - 1})


def row_gaps(torch, registry, cfg, params, rc, x, x_ref, pos):
    """(B, len(pos)): at each position, the largest logit gap between two
    final hidden states over the largest |logit| of `x_ref`."""
    idx = torch.tensor(pos, device=x.device)
    got = registry.unembed(cfg, params, x[:, idx], rc).float()
    want = registry.unembed(cfg, params, x_ref[:, idx], rc).float()
    return (got - want).abs().amax(-1) / want.abs().amax(-1)


def prefill_run(torch, fa, cfg, params, dev, batch, impl, force=None):
    """One bf16 prefill through build_prefill_step on `impl` (`force`
    overrides arguments of every flash call: a planted fault).  Returns
    its record (wall s, peak GiB, K3 launches by variant, cache shapes),
    the final hidden states, and for MoE each layer's experts and dropped
    assignments."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import registry
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import build_prefill_step

    B, S = batch["tokens"].shape
    step = build_prefill_step(
        cfg, RunConfig(seq_len=S, global_batch=B, kind="prefill",
                       attn_impl=impl), device=dev)
    cuda = torch.device(dev).type == "cuda"
    sync(torch, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0
    fa.VARIANT_LAUNCHES = dict.fromkeys(fa.VARIANTS, 0)
    with Spy(torch, registry, "forward", keep=lambda o: o[0]) as fwd, \
            Spy(torch, moe_lib, "route", keep=lambda o: o[1]) as route, \
            Spy(torch, moe_lib, "dispatch",
                keep=lambda o: int((~o[2]).sum())) as drop, \
            Spy(torch, fa, "flash_attention", force=force):
        t = time.perf_counter()
        tok, cache = step(params, batch)
        sync(torch, dev)
        wall = time.perf_counter() - t
    rec = {"model": cfg.name, "layers": cfg.n_layers, "B": B, "S": S,
           "compute": "bfloat16", "attn_impl": impl, "wall_s": wall,
           "launches": fa.LAUNCHES,
           "variant_launches": dict(fa.VARIANT_LAUNCHES),
           "dropped_per_layer": drop.returned,
           "cache": {k: list(v.shape) for k, v in cache.items()},
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30 if cuda
                        else None)}
    x = fwd.returned[0]
    if tuple(tok.shape) != (B, 1) or not bool(torch.isfinite(x).all()) or \
            not all(bool(torch.isfinite(v.float()).all())
                    for v in cache.values()):
        raise AssertionError(f"{cfg.name} prefill on {impl}: wrong shapes "
                             "or non-finite values")
    return rec, x, route.returned


def prefill_batch(torch, cfg, dev, B, S, seed):
    """A prefill batch from `seed`: tokens, and frames or patches where
    the model has them."""
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import make_batch

    return make_batch(cfg, RunConfig(seq_len=S, global_batch=B,
                                     kind="prefill"),
                      torch.Generator(device=dev).manual_seed(seed),
                      with_labels=False)


def flash_vs_ref(torch, fa, cfg, params, dev, B, S, tag):
    """The bf16 prefill on "flash" against the same step on "ref" and
    against a fault planted in the flash call (causal=False), at
    check_positions.  For MoE, only positions routed alike in every layer
    are held to PREFILL_REL_TOL, and at least MOE_AGREE_MIN of them must
    be.  The planted fault must fail the check."""
    from repro_torch.models import moe, registry
    from repro_torch.models.config import RunConfig

    batch = prefill_batch(torch, cfg, dev, B, S, SEED + 4)
    runs = {name: prefill_run(torch, fa, cfg, params, dev, batch, impl,
                              force)
            for name, impl, force in (("flash", "flash", None),
                                      ("ref", "ref", None),
                                      ("planted", "flash",
                                       {"causal": False}))}
    rc = RunConfig(seq_len=S, global_batch=B, kind="prefill")
    pos = check_positions(S)
    res = {}
    for name in ("flash", "planted"):
        gaps = row_gaps(torch, registry, cfg, params, rc, runs[name][1],
                        runs["ref"][1], pos)
        held, slot_differ = torch.ones_like(gaps, dtype=torch.bool), 0.0
        if cfg.is_moe:
            slot_differ, alike = routing_agreement(torch, runs[name][2],
                                                   runs["ref"][2])
            held = alike.reshape(B, S)[:, pos]
        share = float(held.float().mean())
        worst = float(gaps[held].max()) if bool(held.any()) else math.inf
        res[name] = {"slot_differ_share": slot_differ, "held_share": share,
                     "max_rel_gap_held": worst,
                     "max_rel_gap_all": float(gaps.max()),
                     "ok": share >= (MOE_AGREE_MIN if cfg.is_moe else 1.0)
                     and worst <= PREFILL_REL_TOL}
    flash = runs["flash"][0]
    out = {**flash, "positions": len(pos),
           "ref_dropped_per_layer": runs["ref"][0]["dropped_per_layer"],
           "capacity": (moe.capacity(cfg, B * S) if cfg.is_moe else None),
           "ref_wall_s": runs["ref"][0]["wall_s"],
           "ref_peak_gib": runs["ref"][0]["peak_gib"],
           "tolerance_rel": PREFILL_REL_TOL,
           "agree_min": MOE_AGREE_MIN if cfg.is_moe else None, **res}
    emit(f"{tag}_prefill", **out)
    if not res["flash"]["ok"]:
        raise AssertionError(f"{tag}: flash prefill differs from ref: "
                             f"{res['flash']}")
    if res["planted"]["ok"]:
        raise AssertionError(f"{tag}: the check passes the planted fault "
                             f"causal=False: {res['planted']}")
    return out


def card_vs_cpu(torch, cfg, params, dev, B=1, S=FAMILY_CPU_S,
                tag="family"):
    """f32 compute, attn "ref": the same forward (tokens and, where the
    model has them, frames or patches from the seed) on the card and on
    the CPU from one parameter state, logits within FAMILY_REL_TOL of the
    largest; for MoE the top-k experts and the dropped assignments of
    every layer equal and aux within AUX_REL_TOL."""
    from repro_torch.models import layers
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import registry
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import make_batch

    rc = RunConfig(seq_len=S, global_batch=B, kind="prefill",
                   attn_impl="ref", compute_dtype="float32")
    batch = make_batch(cfg, rc, torch.Generator().manual_seed(SEED + 5),
                       with_labels=False)
    host = layers.tree_map(lambda t: t.to("cpu", copy=True), params)
    runs = {}
    for name, where, p in (("card", dev, params), ("cpu", "cpu", host)):
        t = time.perf_counter()
        with Spy(torch, moe_lib, "route", keep=lambda o: o[1]) as route, \
                Spy(torch, moe_lib, "dispatch",
                    keep=lambda o: int((~o[2]).sum())) as drop, \
                torch.no_grad():
            x, _, _, _, aux = registry.forward(
                cfg, p, {k: v.to(where) for k, v in batch.items()}, rc)
            logits = registry.unembed(cfg, p, x, rc).float().cpu()
        runs[name] = {"logits": logits, "aux": float(aux),
                      "top_e": [e.cpu() for e in route.returned],
                      "dropped": drop.returned,
                      "wall_s": time.perf_counter() - t}
    del host
    a, b = runs["card"], runs["cpu"]
    gap = float((a["logits"] - b["logits"]).abs().max()
                / b["logits"].abs().max())
    routes = [bool(torch.equal(x, y)) for x, y in zip(a["top_e"],
                                                      b["top_e"])]
    aux_gap = abs(a["aux"] - b["aux"]) / max(abs(b["aux"]), 1e-30)
    out = {"model": cfg.name, "layers": cfg.n_layers, "B": B, "S": S,
           "compute": "float32", "rel_gap": gap,
           "tolerance_rel": FAMILY_REL_TOL,
           "wall_s": {k: v["wall_s"] for k, v in runs.items()}}
    if cfg.is_moe:
        out.update(top_e_equal=routes, dropped=a["dropped"],
                   cpu_dropped=b["dropped"], aux=a["aux"], cpu_aux=b["aux"],
                   aux_rel_gap=aux_gap, aux_tolerance_rel=AUX_REL_TOL)
    emit(f"{tag}_card_vs_cpu", **out)
    if not gap <= FAMILY_REL_TOL:
        raise AssertionError(f"{tag}: card and CPU logits differ: {gap}")
    if cfg.is_moe and not (all(routes) and a["dropped"] == b["dropped"]
                           and aux_gap <= AUX_REL_TOL):
        raise AssertionError(f"{tag}: card and CPU route differently: "
                             f"{out}")
    return out


def moe_path(torch, fa, parity, ops, dev) -> dict:
    """Phase 14, the MoE path: phi3.5-moe at full width, depth
    MOE_LAYERS, steps a-e (see the module's docstring)."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.config import RunConfig
    from repro_torch.train.trainer import TrainerConfig

    full = get_config(MOE_MODEL)
    cfg = full.scaled(n_layers=MOE_LAYERS)
    free(torch, dev)
    t0 = time.perf_counter()
    params = family_params(torch, cfg, dev)
    emit("moe_init", model=cfg.name, layers=cfg.n_layers,
         params=n_params(params), bytes=4 * n_params(params),
         wall_s=time.perf_counter() - t0)
    # a: the flash prefill against "ref"
    out = {"prefill": flash_vs_ref(torch, fa, cfg, params, dev, PREFILL_B,
                                   PREFILL_S, tag="moe")}
    if torch.device(dev).type == "cuda" and \
            out["prefill"]["variant_launches"] != {
                **dict.fromkeys(fa.VARIANTS, 0), "wgmma": cfg.n_layers}:
        raise AssertionError(f"moe: {out['prefill']['variant_launches']} "
                             f"flash launches, want {cfg.n_layers} wgmma")
    # c: serving, then the f32 prefill against the decode chain (no token
    # dropped: a decode step routes 2 tokens and never drops, so the check
    # sets capacity_factor E / top_k, C = T, for the 128-token prefill)
    out["serve"] = serve_path(torch, fa, parity, cfg, params, tag="moe_",
                              device=dev)
    no_drop = cfg.scaled(capacity_factor=cfg.n_experts / cfg.top_k)
    out["consistency"] = consistency_check(torch, no_drop, params, dev,
                                           phase="moe_prefill_decode")
    del params
    free(torch, dev)
    # b: card vs CPU at depth 1
    one = full.scaled(n_layers=1)
    params = family_params(torch, one, dev, seed=SEED + 6)
    out["card_vs_cpu"] = card_vs_cpu(torch, one, params, dev, tag="moe")
    del params
    free(torch, dev)
    # d: one train step at depth 1, card vs CPU, and twice on the card
    out["train_step"] = train_consistency(torch, one, dev, repeat=True,
                                          phase="moe_train_step")
    free(torch, dev)
    # e: the Trainer on the smoke config, parity-coded checkpoint, resume
    # (the smoke embedding fits in one stripe: its slot 0 is lost)
    tcfg = TrainerConfig(
        model=get_smoke_config(MOE_MODEL),
        rc=RunConfig(seq_len=128, global_batch=8, kind="train",
                     num_microbatches=2),
        n_writers=2, parity=True, dataset_seqs=64, ckpt_every=3, seed=SEED)
    out["trainer"] = train_path(torch, fa, parity, ops, dev, tcfg,
                                lost=("params.embed.bin", 0), tag="moe_")
    out["trainer_launches"] = out["trainer"]["launches"] + \
        out["trainer"]["resume"]["launches"]
    emit("moe", launches=out["prefill"]["launches"],
         variant_launches=out["prefill"]["variant_launches"],
         dropped_per_layer=out["prefill"]["dropped_per_layer"],
         trainer_xor_launches=out["trainer_launches"],
         trainer_rc=dataclasses.asdict(tcfg.rc))
    return out


def continue_decode(torch, cfg, params, dev, B, S0, n=CONTINUE_STEPS,
                    tag="family"):
    """f32, attn "ref": a prefill of S0 tokens (with the config's frames)
    and n decode steps from its cache against a prefill of all S0 + n
    tokens: the logits of the n positions within CONSISTENCY_REL_TOL of
    the largest, and the recurrent state (RWKV) or the K/V cache at the
    end within CONSISTENCY_REL_TOL of its largest entry."""
    from repro_torch.models import registry
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import make_batch

    rc = RunConfig(seq_len=S0 + n, global_batch=B, kind="prefill",
                   attn_impl="ref", compute_dtype="float32")
    batch = make_batch(cfg, rc, torch.Generator(device=dev).manual_seed(
        SEED + 7), with_labels=False)
    t = time.perf_counter()
    with torch.no_grad():
        x, _, full, _, _ = registry.forward(cfg, params, batch, rc,
                                            return_cache=True)
        want = registry.unembed(cfg, params, x[:, S0:], rc).float()
        del x
        pre = {**batch, "tokens": batch["tokens"][:, :S0]}
        _, _, cache, _, _ = registry.forward(cfg, params, pre, rc,
                                             return_cache=True)
        dec = {k: torch.zeros(s, dtype=dt, device=dev) for k, (s, dt) in
               registry.init_cache(cfg, B, S0 + n, torch.float32).items()}
        for k, v in cache.items():
            dec[k][tuple(slice(0, m) for m in v.shape)] = v
        del cache
        got = []
        for j in range(n):
            lg, dec = registry.decode(cfg, params, dec,
                                      batch["tokens"][:, S0 + j:S0 + j + 1],
                                      S0 + j, rc)
            got.append(lg[:, 0].float())
    got = torch.stack(got, dim=1)
    gap = float((got - want).abs().max() / want.abs().max())
    states = {k: float((dec[k] - full[k]).abs().max()
                       / full[k].abs().max().clamp_min(1e-30))
              for k in full if k in ("state", "x_att", "x_ffn", "k", "v")}
    out = {"model": cfg.name, "layers": cfg.n_layers, "B": B,
           "prefill_tokens": S0, "decode_steps": n, "compute": "float32",
           "rel_gap": gap, "cache_rel_gaps": states,
           "tolerance_rel": CONSISTENCY_REL_TOL,
           "wall_s": time.perf_counter() - t}
    emit(f"{tag}_decode_continues", **out)
    if not (gap <= CONSISTENCY_REL_TOL
            and max(states.values()) <= CONSISTENCY_REL_TOL):
        raise AssertionError(f"{tag}: decode from the prefill's cache "
                             f"differs: {out}")
    return out


def ring_decode(torch, cfg, params, dev) -> dict:
    """gemma3's local:global group, f32: RING_STEPS decode steps from zero
    caches, once with the ring-buffered windowed cache and once with the
    full cache, logits held within FAMILY_REL_TOL of the largest at every
    position past the window; both caches' bytes."""
    from repro_torch.models import registry
    from repro_torch.models.config import RunConfig

    steps = RING_STEPS
    rc = RunConfig(seq_len=steps, global_batch=1, kind="decode",
                   attn_impl="ref", compute_dtype="float32")
    caches = {name: {k: torch.zeros(s, dtype=dt, device=dev)
                     for k, (s, dt) in registry.init_cache(
                         cfg, 1, steps, torch.float32,
                         windowed=name == "ring").items()}
              for name in ("ring", "full")}
    nbytes = {name: sum(t.numel() * t.element_size() for t in c.values())
              for name, c in caches.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    toks = torch.randint(0, cfg.vocab, (1, steps), generator=gen,
                         device=dev, dtype=torch.int32)
    W = cfg.sliding_window
    worst_past, worst_before = 0.0, 0.0
    t = time.perf_counter()
    with torch.no_grad():
        for pos in range(steps):
            tok = toks[:, pos:pos + 1]
            a, _ = registry.decode(cfg, params, caches["ring"], tok, pos, rc)
            b, _ = registry.decode(cfg, params, caches["full"], tok, pos, rc)
            gap = float((a - b).abs().max() / b.abs().max())
            if pos >= W:
                worst_past = max(worst_past, gap)
            else:
                worst_before = max(worst_before, gap)
    sync(torch, dev)
    out = {"model": cfg.name, "layers": cfg.n_layers, "window": W,
           "steps": steps, "compute": "float32",
           "max_rel_gap_past_window": worst_past,
           "max_rel_gap_before": worst_before,
           "tolerance_rel": FAMILY_REL_TOL, "cache_bytes": nbytes,
           "wall_s": time.perf_counter() - t}
    emit("gemma3_ring_decode", **out)
    if not (worst_past <= FAMILY_REL_TOL and worst_before <= FAMILY_REL_TOL):
        raise AssertionError(f"ring decode differs from the full cache: "
                             f"{out}")
    return out


def family_path(torch, fa, dev) -> dict:
    """Phase 15: FAMILY_RUNS at full width, each freed before the next: a
    bf16 prefill with its K3 launches by variant (zamba2's against "ref"
    with a planted fault), the family's own decode check, and the f32
    card-vs-CPU check."""
    from repro_torch.configs import get_config

    out = {}
    for arch, depth, B, S, want, cpu_depth in FAMILY_RUNS:
        full = get_config(arch)
        cfg = full if depth is None else full.scaled(n_layers=depth)
        tag = arch.split("-")[0]
        free(torch, dev)
        t0 = time.perf_counter()
        params = family_params(torch, cfg, dev)
        rec = {"params": n_params(params),
               "init_s": time.perf_counter() - t0}
        if arch == "zamba2-7b":
            rec["prefill"] = flash_vs_ref(torch, fa, cfg, params, dev, B, S,
                                          tag=tag)
        else:
            rec["prefill"] = prefill_run(
                torch, fa, cfg, params, dev,
                prefill_batch(torch, cfg, dev, B, S, SEED + 9), "flash")[0]
            emit(f"{tag}_prefill", **rec["prefill"])
        got = {k: v for k, v in rec["prefill"]["variant_launches"].items()
               if v}
        if torch.device(dev).type == "cuda" and got != want:
            raise AssertionError(f"{arch}: K3 launches {got}, want {want}")
        if arch in ("whisper-tiny", "rwkv6-3b"):
            rec["decode"] = continue_decode(torch, cfg, params, dev, B, S,
                                            tag=tag)
        elif arch == "gemma3-12b":
            rec["decode"] = ring_decode(torch, cfg, params, dev)
        if cpu_depth != cfg.n_layers:
            del params
            free(torch, dev)
            cfg = full.scaled(n_layers=cpu_depth)
            params = family_params(torch, cfg, dev, seed=SEED + 6)
        rec["card_vs_cpu"] = card_vs_cpu(torch, cfg, params, dev, tag=tag)
        del params
        rec["wall_s"] = time.perf_counter() - t0
        emit("family", model=arch, params=rec["params"],
             prefill_wall_s=rec["prefill"]["wall_s"], variant_launches=got,
             wall_s=rec["wall_s"])
        out[arch] = rec
    return out


# ------------------------------------------------ phase 16: multi-device

# a one-rank NCCL process group and a (1, 1) ("data", "model") mesh on the
# card: the sharded paths run on DTensors of CUDA tensors there (the card
# is one; NCCL refuses two ranks on it)
PAR_MESH = (1, 1)
# sharded vs unsharded phase-12 training: losses relative (bit-equal
# expected: each local op is the unsharded one on the same tensors)
PAR_TRAIN_STEPS = 2
PAR_TRAIN_REL = 1e-6
# the sharded MoE against the global dispatch, f32, at depth 1
PAR_MOE_T = 4096
PAR_MOE_TOL = 1e-6


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def par_trainer(torch, tcfg, dev, mesh):
    """A phase-12 Trainer (no parity: phase 12 holds it) run
    PAR_TRAIN_STEPS, on `mesh` or unsharded: (trainer, metrics, step
    seconds, peak GiB)."""
    from repro_torch.core import LustreCluster
    from repro_torch.train.trainer import Trainer

    cluster = LustreCluster(osts=4, mdses=1, clients=2, commit_interval=64,
                            device=dev, max_cached_mb=0)
    tr = Trainer(cluster, tcfg, mesh=mesh)
    tr.init_state()
    real, step_s = tr.step_fn, []

    def timed(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    tr.step_fn = timed
    torch.cuda.reset_peak_memory_stats()
    metrics = tr.run(PAR_TRAIN_STEPS)
    return tr, metrics, step_s, torch.cuda.max_memory_allocated() / 2**30


def par_train(torch, dev, mesh) -> dict:
    """Phase 16 a: phase 12's training (qwen3-4b full width, 2 layers,
    4 x 4096 tokens in 4 microbatches, bf16 compute, "auto" attention),
    unsharded and through Trainer(mesh=...) with fsdp "on", from one seed
    on the same batches; then the sharded trainer's checkpoint restored
    by Trainer.resume(mesh=None), byte for byte."""
    import dataclasses

    from repro_torch.models.layers import tree_full, tree_items
    from repro_torch.train.trainer import Trainer

    base = train_config()
    tcfg = dataclasses.replace(
        base, parity=False, ckpt_every=PAR_TRAIN_STEPS,
        rc=dataclasses.replace(base.rc, fsdp="on"))
    plain, want, plain_s, plain_peak = par_trainer(torch, tcfg, dev, None)
    del plain
    free(torch, dev)
    sharded, got, step_s, peak = par_trainer(torch, tcfg, dev, mesh)
    gaps = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
            for a, b in zip(got, want)]
    t = time.perf_counter()
    back = Trainer.resume(sharded.cluster, tcfg, mesh=None)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    saved = dict(tree_items(tree_full(sharded._state_tree())))
    restored = dict(tree_items(back._state_tree()))
    differ = [".".join(k) for k in saved if k not in restored
              or saved[k].dtype != restored[k].dtype
              or not torch.equal(saved[k].to(restored[k].device),
                                 restored[k])]
    wg = sharded.params["layers"]["mlp"]["wg"]
    out = {"mesh": list(PAR_MESH), "fsdp": tcfg.rc.fsdp,
           "wg_placements": str(wg.placements),
           "losses": [m["loss"] for m in got],
           "plain_losses": [m["loss"] for m in want],
           "grad_norms": [m["grad_norm"] for m in got],
           "plain_grad_norms": [m["grad_norm"] for m in want],
           "loss_rel_gaps": gaps, "tolerance_rel": PAR_TRAIN_REL,
           "bit_equal": [m["loss"] for m in got] == [m["loss"] for m in
                                                    want],
           "step_s": step_s, "plain_step_s": plain_s,
           "peak_gib": peak, "plain_peak_gib": plain_peak,
           "resume_s": resume_s, "resume_step": back.step,
           "leaves_compared": len(saved), "leaves_differ": differ}
    emit("parallel_train", **out)
    del sharded, back, saved, restored
    free(torch, dev)
    if not max(gaps) <= PAR_TRAIN_REL or differ or \
            out["resume_step"] != PAR_TRAIN_STEPS:
        raise AssertionError(f"sharded training: {out}")
    return out


def par_prefill(torch, fa, dev, mesh) -> dict:
    """Phase 16 b: phase 9's flash prefill (qwen3-4b, 36 layers, B=2 x
    4096, bf16 compute) unsharded and on the mesh (parameters placed by
    steps.param_specs): K3 launches once a layer through local_map and
    the final hidden states are bit-equal."""
    from repro_torch.models import layers, registry
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import build_prefill_step, param_specs

    cfg, params = model_params(torch, dev)
    tokens = prefill_tokens(torch, cfg, dev)
    rc = RunConfig(seq_len=PREFILL_S, global_batch=PREFILL_B,
                   kind="prefill", attn_impl="flash")
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        p = params if m is None else layers.tree_distribute(
            params, m, param_specs(cfg, rc, m))
        step = build_prefill_step(cfg, rc, device=dev, mesh=m)
        walls = []
        for _ in range(2):                  # the second run warm
            fa.LAUNCHES = 0
            with Spy(torch, registry, "forward",
                     keep=lambda out: out[0]) as fwd:
                torch.cuda.synchronize()
                t = time.perf_counter()
                tok, cache = step(p, {"tokens": tokens})
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
        x = fwd.returned[-1]
        runs[name] = {"x": x.full_tensor() if m is not None else x,
                      "launches": fa.LAUNCHES, "wall_s": walls,
                      "next": (tok.full_tensor() if m is not None
                               else tok).reshape(-1).tolist()}
        del cache, p
    equal = torch.equal(runs["plain"]["x"], runs["mesh"]["x"])
    out = {"launches": runs["mesh"]["launches"],
           "plain_launches": runs["plain"]["launches"],
           "bit_equal": equal, "next_tokens": runs["mesh"]["next"],
           "plain_next_tokens": runs["plain"]["next"],
           "wall_s": runs["mesh"]["wall_s"],
           "plain_wall_s": runs["plain"]["wall_s"]}
    emit("parallel_prefill", **out)
    del params, runs
    free(torch, dev)
    if out["launches"] != cfg.n_layers or not equal:
        raise AssertionError(f"sharded flash prefill: {out}")
    return out


def par_moe(torch, dev, mesh) -> dict:
    """Phase 16 c: phi3.5-moe at full width, depth 1, f32: the shard-local
    dispatch (moe_ffn_sharded, rc.shard_moe_tokens) on the mesh against
    the global dispatch on PAR_MOE_T tokens from the seed: y, aux and the
    dropped assignments."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.config import RunConfig

    cfg = get_config(MOE_MODEL).scaled(n_layers=1)
    params = family_params(torch, cfg, dev, seed=SEED + 16)
    p = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    x = torch.randn((PAR_MOE_T, cfg.d_model), generator=gen, device=dev)
    rc = RunConfig(seq_len=PAR_MOE_T, global_batch=1, kind="prefill",
                   compute_dtype="float32", shard_moe_tokens=True)
    with torch.no_grad():
        want_stats, got_stats = {}, {}
        y0, aux0 = moe._moe_ffn_global(cfg, p, x, rc, want_stats)
        y, aux = moe.moe_ffn_sharded(cfg, p, x, rc, mesh, got_stats)
        torch.cuda.synchronize()
        y, aux = y.full_tensor(), aux.full_tensor()
    out = {"tokens": PAR_MOE_T, "max_abs_err": float((y - y0).abs().max()),
           "aux": float(aux), "global_aux": float(aux0),
           "dropped": got_stats["dropped"],
           "global_dropped": want_stats["dropped"],
           "tolerance": PAR_MOE_TOL}
    emit("parallel_moe", **out)
    del params, p, x, y, y0
    free(torch, dev)
    if not (out["max_abs_err"] <= PAR_MOE_TOL and abs(
            out["aux"] - out["global_aux"]) <= PAR_MOE_TOL
            and out["dropped"] == out["global_dropped"]):
        raise AssertionError(f"sharded MoE: {out}")
    return out


def par_roofline(prefill, train, smi) -> dict:
    """Phase 16 d: the qwen3-4b prefill (B=2 x 4096, 36 layers, bf16,
    "flash", whose kernel the count sees as its plain version) and the
    phase-12 train step, counted on fake tensors at those shapes; beside
    their warm times on the card, the first MFU figures."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.models.config import RunConfig
    from repro_torch.tools import roofline

    cells = {"prefill": (get_config(MODEL), RunConfig(
                 seq_len=PREFILL_S, global_batch=PREFILL_B, kind="prefill",
                 attn_impl="flash"), prefill["plain_wall_s"][-1]),
             "train": (train_config().model, train_config().rc,
                       train["plain_step_s"][-1])}
    out = {"nvidia_smi": smi}
    for name, (cfg, rc, seconds) in cells.items():
        rec = trace_cell(cfg, rc)
        r, h = rec["roofline"], rec["hlo_cost"]
        out[name] = {"flops": h["flops"], "traffic_bytes": h["traffic_bytes"],
                     "model_flops": r["model_flops"],
                     "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                     "collective_s": r["collective_s"],
                     "measured_s": seconds,
                     "mfu": roofline.mfu(cfg, rc, seconds),
                     "count_s": rec["compile_s"]}
    print(json.dumps({"roofline": out}), flush=True)
    return out


def parallel(torch, fa, dev, smi) -> dict:
    """Phase 16: the multi-device paths on a one-rank NCCL mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", PAR_MESH,
                                mesh_dim_names=("data", "model"))
        train = par_train(torch, dev, mesh)
        prefill = par_prefill(torch, fa, dev, mesh)
        moe_out = par_moe(torch, dev, mesh)
    finally:
        dist.destroy_process_group()
    roof = par_roofline(prefill, train, smi)
    out = {"train": train, "prefill": prefill, "moe": moe_out,
           "roofline": roof, "phase16_s": time.perf_counter() - t0}
    emit("parallel", phase16_s=out["phase16_s"],
         mesh_launches=prefill["launches"], host_peak_gib=host_peak_gib())
    return out


# phase 17: the SSD kernel at the docs cell's shapes (zamba2-7b: H = 112,
# P = N = 64, chunk 256, one prompt a call)
SSD_LENGTHS = (512, 1024, 2048, 4096)
SSD_HEADS, SSD_CHUNK = 112, 256


def ssd_inputs(torch, B, S, H, seed, dev, N=64):
    """A block's SSD inputs as `_mamba_block` hands them (views of one
    activation), drawn as the docs cell's Mamba2 leaves are: x, B, C silu
    of normal draws in bf16, dt = softplus(raw + dt_bias) with dt0
    log-uniform in [0.001, 0.1], A uniform in [1, 16]; state size N."""
    P = 64
    g = torch.Generator(device=dev).manual_seed(seed)
    xbc = torch.nn.functional.silu(torch.randn(
        B, S, H * P + 2 * N, generator=g, device=dev)).to(torch.bfloat16)
    u = torch.rand(H, generator=g, device=dev)
    dt0 = torch.exp(math.log(1e-3) + (math.log(0.1) - math.log(1e-3)) * u)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device=dev)
        + dt0 + torch.log(-torch.expm1(-dt0)))
    a = -(1.0 + 15.0 * torch.rand(H, generator=g, device=dev))
    xh = xbc[..., :H * P].unflatten(-1, (H, P))
    return (xh, xbc[..., H * P:H * P + N], xbc[..., H * P + N:], dt * a,
            dt)


def ssd_cost(B, S, H, Q, clock_mhz, N=64) -> dict:
    """The least time of one block's SSD: its bytes (x, B, C, da, dt read
    once, y and the final state written once) at HBM_BYTES_PER_S, the
    products it needs (C B^T once a chunk and att x on the lower
    triangles, the chunk states, C S_{c-1} past the first chunk) at the
    bf16 peak, one exp a kept pair at exp2_per_s; and the design's own
    products (C B^T for each head, B w in two pieces, S_{c-1} in three,
    over whole 16 x 16 tiles of the triangles) at the bf16 peak."""
    P = 64
    nc, T = S // Q, Q // 16
    nbytes = (B * S * H * P * (2 + 4) + 2 * B * S * N * 2
              + 2 * B * S * H * 4 + B * H * N * P * 4)
    kept = Q * (Q + 1) // 2
    states, inter = 2 * B * S * H * N * P, 2 * B * (S - Q) * H * N * P
    flops = 2 * B * nc * kept * (N + H * P) + states + inter
    tiles = B * nc * H * T * (T + 1) // 2
    design = tiles * 2 * 256 * (N + P) + 2 * states + 3 * inter
    exps = B * nc * H * kept
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "products": flops / BF16_FLOPS_PER_S * 1e3,
             "exp": exps / exp2_per_s(clock_mhz) * 1e3}
    by = max(terms, key=terms.get)
    return {"bytes": nbytes, "flops": flops, "design_flops": design,
            "exps": exps, "terms_ms": terms, "bound_ms": terms[by],
            "bound_by": by,
            "design_bound_ms": max(terms["bytes"], terms["exp"],
                                   design / BF16_FLOPS_PER_S * 1e3)}


def time_ssd(torch, dev, lengths=SSD_LENGTHS, H=SSD_HEADS, N=64,
             label="ssd") -> dict:
    """Phase 17: at each docs length the kernel, its output held to
    `_ssd_chunked`'s on the same inputs (TF32 off; `_card.ssd_close`),
    both timed
    (time_on_card: graph replays over a pool of inputs past the L2)
    beside the bound; at other `lengths`, heads `H` and state size `N`
    for `time_ssd_sizes`."""
    import _card
    from repro_torch.kernels import ssd
    from repro_torch.models import zamba2

    torch.backends.cuda.matmul.allow_tf32 = False
    clock = sm_clock_mhz()
    out = {}
    with torch.no_grad():
        for S in lengths:
            cost = ssd_cost(1, S, H, SSD_CHUNK, clock, N)
            pool = [ssd_inputs(torch, 1, S, H, SEED + i, dev, N)
                    for i in range(max(2, -(-64_000_000 // cost["bytes"])))]
            _card.ssd_close(ssd.ssd_chunked(*pool[0], SSD_CHUNK),
                            zamba2._ssd_chunked(*pool[0], SSD_CHUNK))
            kern = time_on_card(torch, lambda t: ssd.ssd_chunked(
                *t, SSD_CHUNK), pool)
            plain = time_on_card(torch, lambda t: zamba2._ssd_chunked(
                *t, SSD_CHUNK), pool[:2], reps=5)
            out[S] = {"B": 1, "H": H, "N": N, "chunk": SSD_CHUNK,
                      "ms": kern["graph_ms"],
                      "stream_ms": kern["stream_ms"],
                      "plain_ms": plain["graph_ms"],
                      "plain_stream_ms": plain["stream_ms"], **cost,
                      "bound_share": cost["bound_ms"] / kern["graph_ms"],
                      "sm_clock_mhz": clock}
            del pool
            torch.cuda.empty_cache()
    emit("kernel_time", kernel=label, times=out)
    return out


# phase 17 at Granite 4.0-H Small's state size (N = 128,
# H = 128) beside zamba2's (N = 64, H = 112), a block a call
SSD_SIZE_LENGTHS = (2048, 4096, 6144, 8192)
GRANITE_SSD_HEADS = 128


def time_ssd_sizes(torch, dev) -> dict:
    """Phase 17 at Granite's state size: time_ssd at N = 128 and at
    N = 64 over SSD_SIZE_LENGTHS."""
    return {"n128": time_ssd(torch, dev, SSD_SIZE_LENGTHS, GRANITE_SSD_HEADS,
                             128, "ssd_n128"),
            "n64": time_ssd(torch, dev, SSD_SIZE_LENGTHS, SSD_HEADS, 64,
                            "ssd_n64")}


def bf16_params(torch, cfg, dev, seed=SEED) -> dict:
    """Random bf16 parameters of `cfg` on `dev`, drawn as
    layers.tree_init draws them but a slice of a leaf's leading (layer)
    axis at a time: a 64 GB model never holds a float32 leaf."""
    from repro_torch.models import layers, registry
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for path, d in layers.tree_items(registry.param_defs(cfg)):
        a = torch.empty(d.shape, dtype=torch.bfloat16, device=dev)
        if d.init in ("zeros", "ones"):
            a.fill_(float(d.init == "ones"))
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale / math.sqrt(max(1, fan_in))
            for part in (a if len(d.shape) >= 3 else [a]):
                part.copy_(torch.randn(part.shape, generator=gen,
                                       device=dev).mul_(std))
        layers.tree_set(out, path, a)
    return out


# phase 17b: one request of each path that runs the SSD or the MoE row
# kernels, at a prompt length of its cell (config module, layers kept or
# 0 for all, tokens): zamba2-7b whole (docs), Granite 4.0-H Small whole
# (rag), the chat cell's phi3.5-moe stage of 16 layers (chat's median)
REQUESTS = (("zamba2_7b", 0, 4096), ("granite4_h_small", 0, 8192),
            ("phi35_moe", 16, 1024))


def kernel_requests(torch, dev) -> dict:
    """Phase 17b: each of REQUESTS through build_prefill_step (bf16_params,
    chunk 256, flash), warmed once, then counted (`_card.counted`): one
    SSD launch a Mamba2 block, `moe.kernel` and two row-kernel launches
    an MoE layer, and neither `ssd.chunked` nor `moe.plain`; then a bf16
    training forward and backward of phi3.5-moe at 2 layers on 1024
    tokens: `moe.plain` once a layer, no row-kernel launch, every
    gradient finite."""
    import importlib

    import _card
    from repro_torch.configs import phi35_moe
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import build_prefill_step

    out = {}
    for module, layers, S in REQUESTS:
        cfg = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
        cfg = cfg.scaled(n_layers=layers) if layers else cfg
        params = bf16_params(torch, cfg, dev)
        step = build_prefill_step(cfg, RunConfig(
            seq_len=S, global_batch=1, kind="prefill",
            param_dtype="bfloat16", attn_impl="flash",
            ssm_chunk=SSD_CHUNK), device=dev)
        toks = torch.randint(0, cfg.vocab, (1, S), device=dev,
                             generator=torch.Generator(dev).manual_seed(SEED),
                             dtype=torch.int32)
        step(params, {"tokens": toks})
        _, got = _card.counted(lambda: step(params, {"tokens": toks}))
        moe = cfg.n_layers if cfg.n_experts else 0
        want = {"ssd": cfg.n_layers if cfg.family == "zamba2" else
                cfg.layer_types.count("mamba"), "ssd.chunked": 0,
                "moe.kernel": moe, "moe.plain": 0, "moe_rows": 2 * moe}
        out[cfg.name] = {"S": S, **{n: got.get(n, 0)
                                    for n in (*want, "flash")}}
        del params, step
        free(torch, dev)
        if any(out[cfg.name][n] != w for n, w in want.items()):
            raise AssertionError(f"{cfg.name}, {S} tokens: "
                                 f"{out[cfg.name]}; {want} wanted")
    cfg = phi35_moe.CONFIG.scaled(n_layers=2)
    rc = RunConfig(seq_len=1024, global_batch=1, kind="train",
                   param_dtype="bfloat16", compute_dtype="bfloat16")
    toks = torch.randint(0, cfg.vocab, (1, 1024), device=dev,
                         generator=torch.Generator(dev).manual_seed(SEED))
    grads, got = _card.train_step(cfg, rc, bf16_params(torch, cfg, dev,
                                                       SEED + 18), toks)
    out["train"] = {"layers": cfg.n_layers, "finite_grads": all(
        bool(torch.isfinite(g).all()) for g in grads),
        **{n: got.get(n, 0) for n in ("moe.kernel", "moe.plain",
                                      "moe_rows")}}
    del grads
    free(torch, dev)
    emit("kernel_requests", **out)
    if out["train"] != {"layers": 2, "finite_grads": True, "moe.kernel": 0,
                        "moe.plain": 2, "moe_rows": 0}:
        raise AssertionError(f"training step: {out['train']}")
    return out


# phase 18: the MoE's row kernels (`kernels.moe_rows`, csrc/moe_rows.cu)
# at Granite 4.0-H Small's routing (72 experts, top-10) and the chat
# cell's phi3.5-moe (16, top-2), d = 4096, a layer a call
MOE_ROWS_SHAPES = {"granite": (72, 10, (2048, 4096, 6144, 8192)),
                   "chat": (16, 2, (128, 512, 1024, 2048, 4096, 8192))}
MOE_ROWS_D = 4096


def moe_rows_inputs(torch, E, k, T, seed, dev):
    """One layer's dispatch and combine inputs as the router makes them:
    x (T, d) bf16 of standard normal draws, a router (d, E) of std
    1 / sqrt(d), `moe.route` and the unchanged `moe.dispatch` at capacity
    1.25, and a drawn (E, C, d) bf16 expert output.  Returns (cfg, C, x,
    top_p, order, dest, keep, out)."""
    import types

    from repro_torch.models import moe
    cfg = types.SimpleNamespace(n_experts=E, top_k=k, capacity_factor=1.25)
    C = moe.capacity(cfg, T)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(T, MOE_ROWS_D, generator=g, device=dev)
    router = torch.randn(MOE_ROWS_D, E, generator=g, device=dev) / \
        math.sqrt(MOE_ROWS_D)
    top_p, top_e, _ = moe.route(cfg, {"router": router}, x)
    order, dest, keep = moe.dispatch(cfg, top_e, C)
    out = torch.randn(E, C, MOE_ROWS_D, generator=g,
                      device=dev).to(torch.bfloat16)
    return cfg, C, x.to(torch.bfloat16), top_p, order, dest, keep, out


def moe_rows_cost(E, k, T, C, kept) -> dict:
    """The least time of each kernel, bytes at HBM_BYTES_PER_S: the
    dispatch writes the whole buffer (empty rows too) and slot_row and
    reads x, order and dest once; the combine reads the kept rows,
    slot_row and the gates once and writes y."""
    d2 = MOE_ROWS_D * 2
    disp = E * C * d2 + T * d2 + T * k * (8 + 8 + 4)
    comb = kept * d2 + T * k * (4 + 4) + T * d2
    return {"dispatch_bytes": disp, "combine_bytes": comb,
            "dispatch_bound_ms": disp / HBM_BYTES_PER_S * 1e3,
            "combine_bound_ms": comb / HBM_BYTES_PER_S * 1e3}


def time_moe_rows(torch, dev) -> dict:
    """Phase 18: at each shape of MOE_ROWS_SHAPES the two kernels, held to
    `_scatter` and `_combine` (`_card.moe_rows_close`), timed
    (time_on_card, graph replays over a pool past the L2) beside their
    bounds and beside `_scatter` / `_combine`."""
    import _card
    from repro_torch.kernels import moe_rows
    from repro_torch.models import moe
    bf16 = torch.bfloat16
    out = {}
    with torch.no_grad():
        for name, (E, k, lengths) in MOE_ROWS_SHAPES.items():
            for T in lengths:
                _, C, x, top_p, order, dest, keep, eo = moe_rows_inputs(
                    torch, E, k, T, SEED + T, dev)
                buf, slot_row = moe_rows.dispatch_rows(x, order, dest, E, C,
                                                       k)
                _card.moe_rows_close(
                    buf, moe._scatter(x, order, dest, E, C, k, bf16),
                    moe_rows.combine_rows(eo, slot_row, top_p),
                    moe._combine(eo, dest, order, top_p, k))
                del buf
                kept = int(keep.sum())
                cost = moe_rows_cost(E, k, T, C, kept)
                pool = [(x, order, dest, eo, slot_row, top_p)]
                for i in range(1, max(2, -(-64_000_000 //
                                           cost["dispatch_bytes"]))):
                    _, _, *more = moe_rows_inputs(torch, E, k, T,
                                                  SEED + T + i, dev)
                    xi, tpi, oi, di, _, eoi = more
                    _, sri = moe_rows.dispatch_rows(xi, oi, di, E, C, k)
                    pool.append((xi, oi, di, eoi, sri, tpi))
                times = {
                    "dispatch": time_on_card(torch, lambda t: moe_rows
                                             .dispatch_rows(t[0], t[1], t[2],
                                                            E, C, k), pool),
                    "dispatch_plain": time_on_card(torch, lambda t: moe
                                                   ._scatter(t[0], t[1], t[2],
                                                             E, C, k, bf16),
                                                   pool, reps=5),
                    "combine": time_on_card(torch, lambda t: moe_rows
                                            .combine_rows(t[3], t[4], t[5]),
                                            pool),
                    "combine_plain": time_on_card(torch, lambda t: moe
                                                  ._combine(t[3], t[2], t[1],
                                                            t[5], k),
                                                  pool, reps=5)}
                row = {"E": E, "k": k, "T": T, "C": C,
                       "dropped_share": 1 - kept / (T * k),
                       **cost, **{f"{n}_ms": t["graph_ms"]
                                  for n, t in times.items()},
                       **{f"{n}_stream_ms": t["stream_ms"]
                          for n, t in times.items()}}
                for n in ("dispatch", "combine"):
                    row[f"{n}_bound_share"] = row[f"{n}_bound_ms"] / \
                        row[f"{n}_ms"]
                out[f"{name}_{T}"] = row
                del pool
                free(torch, dev)
    emit("kernel_time", kernel="moe_rows", times=out)
    return out


def spills(log: str) -> dict:
    """The kernels whose ptxas report (`-Xptxas -v`) shows spills, by
    mangled name: its stack frame and spill line."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[-1].strip()
        elif "spill" in ln and fn and \
                " 0 bytes spill stores, 0 bytes spill loads" not in ln:
            out[fn] = ln.strip()
    return out


def train(torch, fa, parity, ops, dev) -> dict:
    """Phase 12 on the card, then its card/CPU consistency check once the
    trainers and the cluster are gone."""
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = train_config()
    out = train_path(torch, fa, parity, ops, dev, tcfg)
    gc.collect()
    torch.cuda.empty_cache()
    out["consistency"] = train_consistency(torch, tcfg.model, dev)
    emit("train", warm_step_s=out["warm_step_s"],
         tokens_per_s=out["tokens_per_s"], peak_gib=out["peak_gib"],
         save_s=out["save"]["wall_s"], resume_s=out["resume"]["wall_s"],
         restore_s=out["resume"]["restore_s"],
         host_peak_gib=host_peak_gib(), vtime_s=out["vtime_s"],
         launches=out["launches"] + out["resume"]["launches"])
    return out


def families(torch, fa, parity, ops, dev) -> dict:
    """Phases 14 and 15, timed; the K3 launches of each path's prefill by
    variant."""
    t = time.perf_counter()
    moe = moe_path(torch, fa, parity, ops, dev)
    t14 = time.perf_counter() - t
    fam = family_path(torch, fa, dev)
    launches = {"phi3.5-moe": moe["prefill"]["variant_launches"]}
    launches.update({k: v["prefill"]["variant_launches"]
                     for k, v in fam.items()})
    out = {"moe": moe, "family": fam, "launches": launches,
           "phase14_s": t14, "phase15_s": time.perf_counter() - t - t14}
    emit("families", launches=launches, phase14_s=out["phase14_s"],
         phase15_s=out["phase15_s"], host_peak_gib=host_peak_gib())
    return out


def run(mode: str = "") -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops, parity, ref
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit("card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    flash = ["flash_attention", "flash_tf32"]
    names = {"--flash-only": flash, "--parity-only": ["xor_parity"],
             "--train-only": ["xor_parity"], "--entry-only": ["xor_parity"],
             "--parallel-only": flash, "--moe-only": ["moe_rows"]}.get(
                 mode, ["xor_parity", *flash, "ssd", "moe_rows"])
    built = _build.build(names)
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: {"cached": v["cached"], "seconds": v["seconds"],
                        "spills": spills(v["log"]),
                        "ptxas": [ln for ln in v["log"].splitlines()
                                  if "registers" in ln or "spill" in ln
                                  or "arning" in ln or "(C7" in ln]}
                    for k, v in built.items()})

    if mode == "--flash-only":
        time_flash_types(torch, fa, ref, dev)
        time_flash(torch, fa, ref, dev)
        return 0
    if mode == "--train-only":
        train(torch, fa, parity, ops, dev)
        return 0
    if mode == "--entry-only":
        entry_points(torch, parity, ops, dev)
        return 0
    if mode == "--families-only":
        families(torch, fa, parity, ops, dev)
        return 0
    if mode == "--parallel-only":
        parallel(torch, fa, dev, smi)
        return 0
    if mode == "--ssd-only":
        time_ssd(torch, dev)
        time_ssd_sizes(torch, dev)
        kernel_requests(torch, dev)
        return 0
    if mode == "--moe-only":
        time_moe_rows(torch, dev)
        return 0
    times = time_kernel(torch, parity, ref, ops, dev)
    if mode == "--parity-only":
        write_split(torch, ops, parity, dev)
        return 0

    parity.LAUNCHES = fa.LAUNCHES = 0
    parity.TYPE_LAUNCHES = {}
    main = main_path("cuda", MAIN_MIB, ops, parity)
    launches, main_types = parity.LAUNCHES, dict(parity.TYPE_LAUNCHES)
    if launches == 0 or launches != main["lov_calls"] or fa.LAUNCHES:
        raise AssertionError(f"{launches} kernel launches on the main path "
                             f"for {main['lov_calls']} LOV parity calls, "
                             f"{fa.LAUNCHES} flash launches")

    bench_raid5("cuda", parity)
    write_split(torch, ops, parity, dev)

    flash_times = time_flash(torch, fa, ref, dev)
    typed_times = time_flash_types(torch, fa, ref, dev)
    cfg, params = model_params(torch, dev)
    prefill = prefill_path(torch, fa, parity, cfg, params, dev)
    prefill16 = prefill_path(torch, fa, parity, cfg, params, dev,
                             compute="float16", n_runs=1,
                             phase="prefill_f16")
    consistency_check(torch, cfg, params, dev)
    serve_path(torch, fa, parity, cfg, params)
    del params
    trained = train(torch, fa, parity, ops, dev)
    entry = entry_points(torch, parity, ops, dev)
    fams = families(torch, fa, parity, ops, dev)
    par = parallel(torch, fa, dev, smi)
    ssd_times = time_ssd(torch, dev)
    ssd_sizes = time_ssd_sizes(torch, dev)
    requests = kernel_requests(torch, dev)
    moe_times = time_moe_rows(torch, dev)

    k4, fm, fz = times[4], flash_times["main"], flash_times["zamba2_d112"]
    st = ssd_times[max(SSD_LENGTHS)]
    mt = moe_times[f"granite_{max(SSD_SIZE_LENGTHS)}"]
    timed_keys = ("B", "H", "Hkv", "S", "D", "variant", "ms", "strided_ms",
                  "plain_ms", "bound_ms", "bound_by", "bound_term",
                  "library_ms")
    # each variant at its timed shape: wgmma on the main path, mma at bf16
    # D=100, simt at f32 D=128
    variants = [{"name": name, "shape": shape,
                 "launches": prefill["variant_launches"].get(name, 0),
                 **{k: flash_times[shape][k] for k in timed_keys}}
                for name, shape in (("wgmma", "main"), ("mma", "d100_mma"),
                                    ("simt", "main_f32"))]

    def typed_launches(name):
        # the main path's launches of route `name` on float8 or mixed types
        return sum(n for key, n in prefill["dtype_launches"].items()
                   if key.split("/")[0] == name and key.split("/")[1]
                   not in ("float32", "bfloat16", "float16"))
    # the tensor-core routes that decode float8, each at its timed shape
    variants += [{"name": f"{name}/float8", "shape": shape,
                  "launches": typed_launches(name),
                  **{k: typed_times[shape].get(k) for k in (
                      "B", "H", "Hkv", "S", "D", "variant", "ms", "plain_ms",
                      "bound_ms", "bound_by", "bound_term", "library_ms",
                      "design_bound_ms")}}
                 for name, shape in (("wgmma", "e4m3fn"),
                                     ("mma", "e4m3fn_d100_mma"))]
    # the tf32 kernel and the PerTensor simt kernel, each at its timed
    # shapes (the main path launches neither)
    variants += [{"name": name, "source": source, "shape": shape,
                  "launches": typed_launches(name.split("/")[0]),
                  **{k: typed_times[shape].get(k) for k in (
                      "B", "H", "Hkv", "S", "D", "dtypes", "variant", "ms",
                      "plain_ms", "bound_ms", "bound_by", "bound_term",
                      "library_ms", "design_bound_ms")}}
                 for name, source, shape in (
                     ("wgmma_tf32", "src/repro_torch/csrc/flash_tf32.cu",
                      "bf16_q_f16_kv"),
                     ("wgmma_tf32", "src/repro_torch/csrc/flash_tf32.cu",
                      "f16_q_e8m0_k_e5m2_v"),
                     ("simt/per_tensor",
                      "src/repro_torch/csrc/flash_attention.cu",
                      "f32_q_bf16_kv"),
                     ("simt/per_tensor",
                      "src/repro_torch/csrc/flash_attention.cu",
                      "e4m3fn_d320"))]
    print(json.dumps({"kernels": [{
        "name": "xor_parity", "route": "cuda",
        "source": "src/repro_torch/csrc/xor_parity.cu",
        "replaces": "src/repro/kernels/parity.py:23",
        "launches": launches,
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": None,
        "train_launches": trained["launches"] + trained["resume"][
            "launches"],
        "train_largest_call": trained["save"]["largest_call"],
        "train_shape": {k: times["large"]["int32"][k] for k in (
            "K", "N", "ms", "plain_ms", "bound_ms", "bound_by")},
        "entry_launches": entry["launches"],
        "moe_train_launches": fams["moe"]["trainer_launches"],
        "row_types": {"launches": sum(n for t, n in main_types.items()
                                      if t != "int32"),
                      "timed": times["typed"],
                      "large_timed": {d: times["large"][d]
                                      for d in INT_TIMED}}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": prefill["launches"],
        "variant_launches": prefill["variant_launches"],
        "ms": fm["ms"], "strided_ms": fm["strided_ms"],
        "plain_ms": fm["plain_ms"],
        "bound_ms": fm["bound_ms"], "bound_by": fm["bound_by"],
        "library_ms": fm["library_ms"],
        "variants": variants,
        "family_variant_launches": fams["launches"],
        "mesh_launches": par["prefill"]["launches"],
        "d112": {k: fz[k] for k in timed_keys},
        "float16": {"launches": prefill16["launches"],
                    "dtype_launches": prefill16["dtype_launches"],
                    **{k: flash_times["main_f16"][k] for k in timed_keys}},
        "timed": {name: {k: t[k] for k in ("dtype", "width", *timed_keys)}
                  for name, t in flash_times.items()
                  if name not in ("main", "zamba2_d112", "main_f16")},
        "other_types": {
            "launches": {name: typed_launches(name) for name in fa.VARIANTS},
            "timed": {name: {k: t[k] for k in (
                "dtypes", "variant", "width", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_term", "design_bound_ms", "library_ms")}
                for name, t in typed_times.items()}}}, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": None,
        "launches": {m: r["ssd"] for m, r in requests.items()
                     if m != "train"},
        "chunked": {m: r["ssd.chunked"] for m, r in requests.items()
                    if m != "train"},
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "design_bound_ms": st["design_bound_ms"], "library_ms": None,
        "timed": {S: {k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "bound_share")}
                  for S, t in ssd_times.items()},
        "sizes": {n: {S: {k: t[k] for k in ("H", "N", "ms", "bound_ms",
                                             "bound_by", "bound_share")}
                      for S, t in sizes.items()}
                  for n, sizes in ssd_sizes.items()}}, {
        "name": "moe_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_rows.cu",
        "replaces": None,
        "ms": mt["dispatch_ms"] + mt["combine_ms"],
        "plain_ms": mt["dispatch_plain_ms"] + mt["combine_plain_ms"],
        "bound_ms": mt["dispatch_bound_ms"] + mt["combine_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "launches": {m: r["moe_rows"] for m, r in requests.items()
                     if m != "train"},
        "train_launches": requests["train"]["moe_rows"],
        "timed": {n: {k: t[k] for k in (
            "dispatch_ms", "combine_ms", "dispatch_plain_ms",
            "combine_plain_ms", "dispatch_bound_ms", "combine_bound_ms")}
            for n, t in moe_times.items()}}
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    modes = ("--flash-only", "--parity-only", "--train-only", "--entry-only",
             "--families-only", "--parallel-only", "--ssd-only",
             "--moe-only")
    if sys.argv[1:] and (len(sys.argv) > 2 or sys.argv[1] not in modes):
        sys.exit(f"usage: chip_smoke.py [{' | '.join(modes)}]")
    try:
        code = run(sys.argv[1] if sys.argv[1:] else "")
    except Exception:                         # report, never print a result
        traceback.print_exc()
        code = 1
    sys.exit(code)
