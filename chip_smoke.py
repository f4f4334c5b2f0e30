#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the last line:

  1. the card's name and power limit (nvidia-smi);
  2. the build of every kernel from `src/repro_torch/csrc` (nvcc, sm_90a);
  3. the XOR parity kernel against its plain PyTorch version on the card,
     bit-exact, over K in {1..5, 8, 16, 17, 24} rows and N from 1 to
     4194304 lanes, with every missing row reconstructed from row views
     (no concatenation), rows strided inside a larger tensor, and rows
     off a 16-byte boundary; then every other integer row type the
     Pallas kernel takes (int8, uint8, int16, uint16, uint32, int64,
     uint64: the XOR stored in int32 lanes as the Pallas kernel stores
     it) bit for bit, in 16-byte lanes and element by element (rows one
     element off 16 bytes), each missing row rebuilt from the survivors
     in the row type and the int32 parity, and K1 on uint8 and int64 rows
     at K=4, N=262144 timed beside its byte bound; then the largest call
     of phase 12, K=3 rows of 518,782,976 bytes (N = 129,695,744 lanes),
     checked and timed, and uint8 and int64 rows of the same bytes;
  4. kernel times at the shapes of the main path (CUDA events, median;
     replayed from a CUDA graph for the card's own time, and issued from
     Python), beside the memory bound, the copy floor (a device-to-device
     copy of the same bytes), the launch floor (a kernel that writes one
     lane), the plain version and a chain of torch.bitwise_xor; then one
     LOV parity call of 4 x 1 MiB from bytes to bytes, whole and split
     into its pieces;
  5. the main path: a raid5 file of 512 MiB at 1 MiB stripes, 4 data +
     1 parity, written, read clean, read degraded with ost1 dead,
     rebuilt onto a spare through lctl and truncated, all through
     `LustreCluster(device="cuda")` and `LustreClient`, every read
     byte-identical; the kernel's launches are counted over this phase
     only and must equal the LOV's parity and reconstruction calls;
  6. the raid5 section of BENCH_rpc.json reproduced with parity on the
     card; then phase 5's write once more on a fresh cluster, each parity
     call split into its pieces (`write_split`);
  7. the flash-attention kernel, every variant (wgmma, mma, simt) in
     float32, bfloat16 and float16, against its plain version on the card
     (2e-5 in float32, 2e-2 in bfloat16, 5e-3 in float16), over B,
     (H, Hkv), S, D (zamba2's 112 among them), window, causal, Sq != Sk,
     FLASH_EDGES, strided (B,S,H,D) views, NEW_HEAD_DIMS (8 to 1024:
     wgmma at width 64 and on mostly empty last TMA boxes, mma at
     D % 8 != 0 at each width, simt for 16-bit types above 256 and in
     column chunks to 1024), the layouts the TMA cannot take (LAYOUTS: a
     last dimension of stride 2, rows D + 4 apart, a start one element
     off, a (B,S,D,H) tensor's view) and B*H = 65,600 (element by element
     there), after one short call of each compiled kernel; then the
     other types the Pallas kernel computes (each operand read in its own
     type, the output in q's), on the tensor cores where the types have a
     compute type (float8 decoded into bfloat16 or float16 by the wgmma
     and mma kernels; bfloat16 beside float16 and float16 beside e8m0fnu
     decoded into tf32 by the wgmma_tf32 kernel) and on the PerTensor
     simt kernel otherwise: each of the five float8 formats alone and 20
     mixes (MIXED) at TYPED_SHAPES,
     windows -1 and -7 (no window, as in Pallas) on every route, float8
     tensors as (B,S,H,D) views, one byte off an aligned start and with a
     column stride of 2, each element by element against the plain
     version (the rounding of its float32 output within the kernel's own
     error), each launched on the route `fa.route` gives; and at one key
     a row the simt kernel's float8 and 16-bit rounding of 2^20 float32
     bit patterns and its decoding of every float8 byte, and the same
     through the tensor cores: every float8 byte decoded into bfloat16
     and float16, and every bfloat16 pattern rounded to each float8
     format, bit for bit; and through the tf32 kernel every float8 byte,
     every bfloat16 and float16 pattern (subnormals included) and every
     float16 pattern rounded to each float8 format, bit for bit;
  8. at the prefill shapes of qwen3-4b (B=2, S=4096, in bfloat16, float16
     and float32 at D=128 and 64, and one layer of prefill_32k: B=1,
     S=32768), a gemma3-12b global layer (D=256, B=2, S=4096), zamba2-7b's
     shared block (D=112, H=Hkv=32, B=2, S=4096) and qwen3-4b's shape at
     D=96, 80 (wgmma at width 128), 48 (wgmma at width 64), 100 (mma) and
     320 (simt), and q bf16 with float8 (e4m3fn) k and v and all three
     e4m3fn at D=128 (wgmma) and all three at D=100 (mma; no library call
     takes them, and beside the card's float8 bound the design's 16-bit
     one), q bf16 with f16 k and v and q f16 with e8m0fnu k and e5m2 v
     (wgmma_tf32, beside the design's tf32 bound), q f32 with bf16 k and
     v at D=128 and all three e4m3fn at D=320 (PerTensor simt) beside
     simt<float> at D=128 and 320: the kernel
     against its plain version, element by element within a limit scaled
     to each output, then its times beside the bound
     (the largest of the products at the type's peak, the bytes, and one
     exp2 a kept pair at 16 a clock an SM at nvidia-smi's clocks.max.sm),
     the plain version and scaled_dot_product_attention in the same dtype
     (a yardstick the port never calls);
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
 17. the SSD kernel (`kernels.ssd`, csrc/ssd.cu) at the docs cell's shapes
     (zamba2-7b's H = 112, P = N = 64, chunk 256, S = 512 ... 4096, B = 1)
     against `_ssd_chunked` on the same inputs with TF32 off (relative
     Frobenius norm of y and the final state, y element by element),
     timed (graph replays) beside `_ssd_chunked` and its bound (bytes at
     3.35 TB/s, products at the bf16 peak, one exp a kept pair at 16 a
     clock an SM); then 12 docs requests (3 of each length) through
     build_prefill_step on zamba2-7b whole, tracer on: 81 kernel launches
     and no `_ssd_chunked` block each, and the same requests with the
     plain version forced (81 `ssd.chunked` each), each route's median
     wall time a request; then (17c) the kernel at Granite 4.0-H Small's
     N = 128 (H = 128, P = 64, chunk 256) and beside it at N = 64
     (zamba2's H = 112), S = 2048 ... 8192: each held against
     `_ssd_chunked` and timed beside its bound, a block a call; K3 as
     Granite calls it (H = 32, Hkv = 8, D = 128, softmax scale 1/128, on
     the strided views) at the same S against its plain version; and a
     request of each S on Granite 4.0-H Small whole: 36 SSD and 4 K3
     launches each, none of `_ssd_chunked`;
 18. the MoE's row kernels (`kernels.moe_rows`, csrc/moe_rows.cu) at
     Granite 4.0-H Small's routing (72 experts, top-10, T = 2048 ...
     8192) and the chat cell's (16, top-2, T = 128 ... 8192), d = 4096,
     router-made routings at capacity 1.25: the dispatch's buffer equal to
     `_scatter`'s to the bit, y within one unit in the last place of
     `_combine`'s (the share that differs printed), both bit for bit
     against their plain versions and against a repeat, then each timed
     (graph replays) beside its bound (bytes at 3.35 TB/s) and beside
     `_scatter` / `_combine`; then a request of each S on Granite whole
     and of 128 ... 8192 tokens on the chat cell's 16-layer phi3.5-moe
     stage, tracer on, on the kernels (a `moe.kernel` a layer, no
     `moe.plain`, two launches a layer) and forced onto the plain
     functions (a `moe.plain` a layer), with the two routes' logit gap at
     the last position; and a training forward and backward of
     phi3.5-moe at 2 layers: no `moe.kernel`, a `moe.plain` a layer.

Then the kernel summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA card is usable or the port's sources are missing.

    python3 chip_smoke.py --flash-only

is the quick check of the flash-attention kernel alone (phases 1, 2, 7, 8,
after one short call of each compiled kernel); it prints no result
line.  Run it under `timeout` after a change to the kernel: a fault of
its mbarrier pipeline traps after seconds, and the timeout bounds the
rest.

    python3 chip_smoke.py --parity-only

is the same for the XOR parity kernel (phases 1-4 and `write_split`); no
result line.

    python3 chip_smoke.py --train-only

runs phases 1, 2, phase 3's largest shape and phase 12; no result line.

    python3 chip_smoke.py --entry-only

runs phases 1, 2 and 13; no result line.

    python3 chip_smoke.py --families-only

runs phases 1, 2, one short call of each compiled flash kernel, then 14
and 15; no result line.

    python3 chip_smoke.py --ssd-only

runs phases 1, 2 (the SSD and flash libraries) and 17; no result line.

    python3 chip_smoke.py --moe-only

runs phases 1, 2 (the MoE rows library; the flash and SSD libraries are
built at their first call) and 18; no result line.

    python3 chip_smoke.py --typed-times

runs phases 1, 2 and phase 8's typed times (FLASH_TYPED_TIMED) alone;
no result line.  A copy of this file in another checkout times that
checkout's kernels (an older tree's, beside this one's, in one call on
one card; it builds only the sources that checkout has).
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


def rows(torch, k, n, seed, device):
    """(k, n) random int32 lanes on `device`, made from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-2**31, 2**31, (k, n), dtype=torch.int64,
                      generator=g, device=device)
    return x.to(torch.int32)


def max_abs_err(torch, a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernel(torch, parity, ref, dev) -> int:
    """Phase 3: kernel == plain version, bit for bit; returns the largest
    absolute difference seen (0).  Every missing row is reconstructed
    from row views of the input, with no concatenation; survivors that
    are strided rows of a larger tensor and rows that do not start on a
    16-byte boundary are checked too."""
    worst, shapes = 0, 0

    def same(got, want, what):
        nonlocal worst
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(torch, got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"{what} differs from the plain version")

    for k in (1, 2, 3, 4, 5, 8, 16, 17, 24):
        for n in (1, 37, 1000, 4097, 262144, 262145, 4194304):
            x = rows(torch, k, n, k * 1000003 + n, dev)
            p = parity.xor_parity(x)
            same(p, ref.xor_parity_ref(x), f"xor_parity K={k} N={n}")
            for miss in range(k):
                surv = [x[i] for i in range(k) if i != miss]
                same(parity.reconstruct(surv, p), x[miss],
                     f"reconstruct K={k} N={n} row {miss}")
            shapes += 1
    # survivors that are every other row of a larger tensor, read in place
    for k, n in ((4, 262144), (5, 262144), (17, 4097), (24, 262144)):
        x = rows(torch, 2 * k, n, 3 * n + k, dev)[::2]
        p = parity.xor_parity(x)
        same(p, ref.xor_parity_ref(x), f"strided rows K={k} N={n}")
        same(parity.reconstruct(x[1:], p), x[0],
             f"reconstruct from strided rows K={k} N={n}")
        shapes += 1
    # rows that do not start on a 16-byte boundary: the 4-byte lanes
    for k, n in ((3, 37), (4, 262144), (5, 262145), (17, 4097),
                 (24, 262144)):
        x = rows(torch, k, n, 7 * n + k, dev)
        buf = torch.empty(k * n + 1, dtype=torch.int32, device=dev)
        buf[1:].copy_(x.reshape(-1))
        shifted = buf[1:].view(k, n)
        want = ref.xor_parity_ref(x)
        same(parity.xor_parity(shifted), want, f"misaligned K={k} N={n}")
        same(parity.reconstruct(shifted[1:], want), x[0],
             f"misaligned reconstruct K={k} N={n}")
        shapes += 1
    emit("kernel_check", kernel="xor_parity", shapes=shapes,
         max_abs_err=worst, bit_exact=True)
    return worst


# phase 3's integer rows: every row type the Pallas kernel takes besides
# int32 (it stores the XOR in int32: int8/int16 sign-extended, uint8/uint16
# zero-extended, uint32 by its bits, 64-bit types by their low 32 bits)
INT_ROW_TYPES = ("int8", "uint8", "int16", "uint16", "uint32", "int64",
                 "uint64")
INT_TIMED = ("uint8", "int64")          # timed at K=4, N=262144


def int_rows(torch, k, n, dname, seed, device):
    """(k, n) random rows of the integer type `dname` on `device`: random
    bytes, viewed as the type."""
    item = getattr(torch, dname).itemsize
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (k, n * item), dtype=torch.uint8,
                      generator=g, device=device)
    return x.view(getattr(torch, dname))


def check_int_rows(torch, parity, ref, dev) -> dict:
    """Phase 3 on every other integer row type: the kernel against its
    plain version, bit for bit, in 16-byte lanes (rows on 16 bytes, whole
    16-byte rows) and element by element (rows one element off a 16-byte
    boundary, or a row length that is no multiple of 16 bytes), and every
    missing row rebuilt from the survivors in the row type and the int32
    parity (one launch for each of the two types and one over their int32
    results); then K1 on uint8 and int64 rows at K=4, N=262144 timed
    beside its bound (the rows' bytes in, N int32 out)."""
    shapes, launches = 0, parity.LAUNCHES
    by_type = dict(parity.TYPE_LAUNCHES)
    for dname in INT_ROW_TYPES:
        td = getattr(torch, dname)
        for k in (1, 2, 3, 4, 5, 17):
            for n in (1, 37, 4097, 262144, 262147):
                x = int_rows(torch, k, n, dname, k * 7919 + n, dev)
                buf = torch.empty(k * n + 1, dtype=td, device=dev)
                buf[1:].copy_(x.reshape(-1))
                for rows_ in (x, buf[1:].view(k, n)):
                    p = parity.xor_parity(rows_)
                    want = ref.xor_parity_ref(rows_)
                    torch.cuda.synchronize()
                    if not torch.equal(p, want):
                        raise AssertionError(
                            f"xor_parity {dname} K={k} N={n} differs from "
                            "the plain version")
                    for miss in range(min(k, 4) if k > 1 else 0):
                        surv = [rows_[i] for i in range(k) if i != miss]
                        got = parity.reconstruct(surv, p)
                        torch.cuda.synchronize()
                        if not torch.equal(got, ref.to_int32(rows_[miss])):
                            raise AssertionError(
                                f"reconstruct {dname} K={k} N={n} row "
                                f"{miss} differs")
                    shapes += 1
    checked = parity.LAUNCHES - launches
    by_type = {t: n - by_type.get(t, 0)
               for t, n in parity.TYPE_LAUNCHES.items()}
    if not all(by_type.get(t) for t in INT_ROW_TYPES):
        raise AssertionError(f"a row type launched no kernel: {by_type}")
    times = {}
    n = STRIPE // 4
    for dname in INT_TIMED:
        item = getattr(torch, dname).itemsize
        count = -(-(96 << 20) // (4 * n * item))   # > 96 MiB of inputs
        pool = [int_rows(torch, 4, n, dname, 31 * i, dev)
                for i in range(count)]
        kern = time_on_card(torch, parity.xor_parity, pool)
        plain = time_on_card(torch, ref.xor_parity_ref, pool)
        nbytes = 4 * n * item + n * 4
        b = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = 3 * n / INT32_OPS_PER_S * 1e3
        times[dname] = {"K": 4, "N": n, "bytes": nbytes,
                        "ms": kern["graph_ms"], "stream_ms": kern["stream_ms"],
                        "plain_ms": plain["graph_ms"],
                        "bound_ms": max(b, by_ops),
                        "bound_by": "bytes" if b >= by_ops else "operations",
                        "bound_share": max(b, by_ops) / kern["graph_ms"],
                        "library_ms": None}
        del pool
    torch.cuda.empty_cache()
    out = {"types": list(INT_ROW_TYPES), "shapes": shapes,
           "launches": checked, "type_launches": by_type,
           "bit_exact": True, "max_abs_err": 0,
           "timed": times}
    emit("kernel_check_int_rows", kernel="xor_parity", **out)
    return out


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


def bound_ms(k, n) -> tuple[float, str]:
    by_bytes = (k + 1) * n * 4 / HBM_BYTES_PER_S * 1e3
    by_ops = (k - 1) * n / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def time_kernel(torch, parity, ref, ops, dev) -> dict:
    """Phase 4 at the main path's shapes (K=4 and 5 rows of 1 MiB): the
    kernel, the plain version, the chain of K-1 torch.bitwise_xor calls,
    and the copy floor: a device-to-device
    Tensor.copy_ that moves the same (K+1)*N*4 bytes (it reads and writes
    (K+1)*N*2), a yardstick of what the card moves at this size, which
    the port never calls; and the launch floor, the graph-replayed time
    of a PyTorch kernel that zeroes one lane, the least a kernel node
    costs here.  Then one whole parity call of the LOV and its split
    (`split_call`)."""
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
        pool = [rows(torch, k, n, 31 * i + k, dev) for i in range(count)]
        b, by = bound_ms(k, n)
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


# tests/test_kernels.py's TOL, and tests/test_torch_flash.py's for float16
# (one f16 ulp of an output up to 4, plus P rounded to f16: 2^-11 a weight)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 5e-3}
# at the prefill shapes, element by element: see check_flash_scaled.  The
# relative term is 4 units of the type's rounding (2^-9 bf16, 2^-11 f16);
# in float32 only the order of the sums differs.
FLASH_REL_TOL = {"float32": 2.0 ** -17, "bfloat16": 2.0 ** -7,
                 "float16": 2.0 ** -9}
FLASH_ABS_TOL = {"float32": 2e-5, "bfloat16": 1e-4, "float16": 1e-4}
# the head dims phase 7 holds beyond the models' 16-256 (every branch of
# `variant`: wgmma at width 64 (8-56) and on mostly empty last TMA boxes,
# mma for D % 8 != 0 at each width (20, 100, 250), simt for 16-bit types
# above 256 and in column chunks beyond 128 (up to 1024)) and the shapes
# it holds each at, (B, H, Hkv, Sq,
# Sk, window, causal, strided): GQA, a window, Sq != Sk (Sq > Sk too),
# a window without causal on strided views, a longer sequence
NEW_HEAD_DIMS = (8, 20, 24, 40, 48, 56, 80, 96, 100, 120, 136, 160, 192,
                 200, 250, 320, 512, 520, 768, 1024)
NEW_HEAD_DIM_SHAPES = ((1, 4, 2, 192, 192, 0, True, False),
                       (2, 4, 4, 300, 300, 100, True, False),
                       (1, 8, 2, 100, 257, 0, True, False),
                       (2, 4, 2, 130, 130, 64, False, True),
                       (1, 2, 1, 1024, 1024, 0, True, False),
                       (1, 4, 2, 128, 64, 0, True, False))


def qkv(torch, B, H, Hkv, Sq, Sk, D, dtype, seed, dev, strided=False):
    """q (B,H,Sq,D), k, v (B,Hkv,Sk,D) from `seed`, all of `dtype` or each
    of its own where `dtype` is a tuple of three (a float8 tensor rounded
    from normal samples as the reference rounds, float8_e8m0fnu, which
    has no sign, from their magnitudes).  `strided`: True gives
    the (B,H,S,D) views of (B,S,H,D) tensors, as the model passes them;
    the layouts the TMA cannot take (LAYOUTS): "col2" a last dimension of
    stride 2, "row_pad4" rows D + 4 elements apart, "off1" a start one
    element past an aligned one, "perm" the dense (B,H,S,D) view of a
    (B,S,D,H) tensor (column stride H; the output, empty_like(q), takes
    the same strides)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    layouts = {
        False: (lambda h, S: (B, h, S, D), lambda x, h, S: x),
        True: (lambda h, S: (B, S, h, D), lambda x, h, S: x.transpose(1, 2)),
        "col2": (lambda h, S: (B, h, S, 2 * D), lambda x, h, S: x[..., ::2]),
        "row_pad4": (lambda h, S: (B, h, S, D + 4),
                     lambda x, h, S: x[..., :D]),
        "off1": (lambda h, S: (B * h * S * D + 1,),
                 lambda x, h, S: x[1:].view(B, h, S, D)),
        "perm": (lambda h, S: (B, S, D, h),
                 lambda x, h, S: x.permute(0, 3, 1, 2))}
    shape, view = layouts[strided]
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,) * 3

    def mk(heads, S, dt):
        x = torch.randn(shape(heads, S), generator=g, device=dev)
        if dt == torch.float8_e8m0fnu:
            x = x.abs()
        return view(plain().round_to(x, dt), heads, S)
    return (mk(H, Sq, dtypes[0]), mk(Hkv, Sk, dtypes[1]),
            mk(Hkv, Sk, dtypes[2]))


def plain():
    """The kernels' plain versions (`repro_torch.kernels.ref`), imported
    where first used: the script's first lines import no torch."""
    from repro_torch.kernels import ref
    return ref


# the layouts the TMA cannot take, which the mma (16-bit) and simt kernels
# read in place (see qkv)
LAYOUTS = ("col2", "row_pad4", "off1", "perm")


# K3's edges beyond the grid of check_flash, (B, H, Hkv, Sq, Sk, D, window,
# causal): sequences that are not a multiple of the wgmma kernel's 128-row
# tiles, Sq < Sk, a window of 1024 at S=4096, gemma3's D=256 at S=4096 and
# zamba2's D=112 at S=4096
FLASH_EDGES = [(1, 4, 2, 100, 100, 128, 0, True),
               (1, 32, 8, 4000, 4000, 128, 0, True),
               (2, 32, 8, 1000, 4096, 128, 0, True),
               (1, 8, 2, 128, 4000, 256, 100, True),
               (1, 32, 8, 4096, 4096, 128, 1024, True),
               (1, 16, 8, 4096, 4096, 256, 0, True),
               (1, 8, 8, 4000, 4000, 64, 1024, False),
               (1, 32, 32, 4096, 4096, 112, 0, True),
               (1, 4, 4, 4000, 4000, 112, 1024, True)]


def check_flash(torch, fa, ref, dev) -> dict:
    """K3 check: every variant of the kernel against its plain version on
    the card, over B, (H, Hkv), S, D, window, causal and dtype (float32,
    bfloat16, float16), plus Sq != Sk (Sq < Sk, and Sq > Sk where leading
    rows keep no key and must be 0), FLASH_EDGES, strided (B,S,H,D) views
    in and out, and NEW_HEAD_DIMS.  The 16-bit FLASH_EDGES with
    Sk >= 1000 are also held to check_flash_scaled's element-wise limit."""
    worst = dict.fromkeys(FLASH_TOL, 0.0)
    cases = []
    for B in (1, 2):
        for H, Hkv in ((1, 1), (4, 2), (8, 1), (32, 8)):
            for S in (64, 128, 192, 256, 1024):
                for D in (16, 32, 64, 128, 256):
                    cases += [(B, H, Hkv, S, S, D, w, c, False)
                              for w in (0, 32, 100) for c in (True, False)]
    # D=112 (zamba2's shared block): the D=128 pipeline on TMA's zero fill
    for B in (1, 2):
        for H, Hkv in ((1, 1), (4, 4), (32, 32), (8, 2)):
            for S in (64, 192, 1024):
                cases += [(B, H, Hkv, S, S, 112, w, c, False)
                          for w in (0, 100) for c in (True, False)]
    for Sq, Sk in ((1, 128), (64, 256), (100, 1024), (192, 1024), (128, 64)):
        for H, Hkv, D in ((4, 2, 64), (4, 4, 112), (32, 8, 128), (8, 1, 256)):
            cases += [(2, H, Hkv, Sq, Sk, D, w, c, False)
                      for w in (0, 100) for c in (True, False)]
    cases += [(*e, strided) for e in FLASH_EDGES for strided in (False, True)]
    cases += [(2, 4, 2, S, S, D, 0, True, True)
              for S in (100, 192) for D in (16, 32, 64, 112, 128, 256)]
    cases += [(B, H, Hkv, Sq, Sk, D, w, c, strided)
              for D in NEW_HEAD_DIMS
              for B, H, Hkv, Sq, Sk, w, c, strided in NEW_HEAD_DIM_SHAPES]
    # the layouts the TMA cannot take, read in place by mma and simt
    cases += [(2, 4, 2, Sq, Sk, D, w, c, layout)
              for layout in LAYOUTS for D in (20, 32, 64, 100, 128, 320)
              for Sq, Sk, w, c in ((300, 300, 0, True), (192, 257, 100,
                                                         False))]
    # B*H above 65535 (grid x): wgmma/simt at D=64, mma/simt at D=100
    cases += [(2, 32800, 8200, 16, 16, D, 0, True, False) for D in (64, 100)]
    n, scaled, held = 0, [], {}
    by_variant = dict.fromkeys(fa.VARIANTS, 0.0)
    before = dict(fa.VARIANT_LAUNCHES)
    for dname in FLASH_TOL:
        dtype = getattr(torch, dname)
        for i, (B, H, Hkv, Sq, Sk, D, w, c, strided) in enumerate(cases):
            q, k, v = qkv(torch, B, H, Hkv, Sq, Sk, D, dtype, i, dev, strided)
            name = fa.route(q, k, v)
            got = fa.flash_attention(q, k, v, causal=c, window=w)
            want = ref.flash_attention_ref(q, k, v, causal=c, window=w)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            many = B * H > 65535
            if many or dname != "float32" and Sk >= 1000 and (
                    B, H, Hkv, Sq, Sk, D, w, c) in FLASH_EDGES:
                # at long S a fixed limit is loose, and over B*H = 65,600
                # rows of 16 keys outputs reach past 4, where one bf16
                # rounding exceeds it: hold these element by element
                check = check_flash_scaled(torch, ref, got, want, q, k, v,
                                           causal=c, window=w)
                scaled.append({"dtype": dname, "B": B, "H": H, "Hkv": Hkv,
                               "Sq": Sq, "Sk": Sk, "D": D, "window": w,
                               "causal": c, "strided": strided,
                               "worst_over_limit": check["worst_over_limit"]})
                if not check["worst_over_limit"] <= 1.0:
                    raise AssertionError(
                        f"flash_attention {dname} B={B} H={H} Hkv={Hkv} "
                        f"Sq={Sq} Sk={Sk} D={D} window={w} causal={c} "
                        f"strided={strided} differs from its plain version:"
                        f" {check}")
            if not many and not err <= FLASH_TOL[dname]:
                raise AssertionError(
                    f"flash_attention {dname} B={B} H={H} Hkv={Hkv} Sq={Sq} "
                    f"Sk={Sk} D={D} window={w} causal={c} strided={strided}"
                    f" ({name}): max abs err {err} > "
                    f"{FLASH_TOL[dname]}")
            if Sq > Sk and c:            # rows before the first key are 0
                if got[:, :, :Sq - Sk].abs().max() != 0:
                    raise AssertionError("a row that keeps no key is not 0")
            if not many:
                worst[dname] = max(worst[dname], err)
                by_variant[name] = max(by_variant[name], err)
            held.setdefault(name, set()).add((dname, D))
            n += 1
            del q, k, v, got, want
    ran = {k: v - before[k] for k, v in fa.VARIANT_LAUNCHES.items()}
    head_dims = {name: {dn: sorted(D for d, D in pairs if d == dn)
                        for dn in FLASH_TOL}
                 for name, pairs in sorted(held.items())}
    emit("kernel_check", kernel="flash_attention", shapes=n,
         max_abs_err=worst, max_abs_err_by_variant=by_variant,
         tolerance=FLASH_TOL, variant_launches=ran,
         head_dims=head_dims, edges_over_scaled_limit=scaled)
    # every kernel of one type (wgmma_tf32 takes mixes only: phase 7's
    # check_flash_types holds it)
    if not all(ran[name] for name in ("simt", "mma", "wgmma")):
        raise AssertionError(f"a flash variant was never checked: {ran}")
    return {"max_abs_err": worst, "by_variant": by_variant, "shapes": n,
            "head_dims": sorted({D for pairs in held.values()
                                 for _, D in pairs})}


# phase 7's other types: each float8 format alone and the mixes below
# (each operand read in its own type, the output in q's), on the route
# `fa.route` gives (the tensor cores where the types have a compute type
# C, `fa.compute_type`: wgmma at D=64 and 128, mma at D=40, wgmma_tf32 at
# D=64 and 128 (and at 40 where no operand is float8) for the tf32 sets;
# the PerTensor simt kernel at D=320, for the tf32 sets off the TMA's
# layouts and for the sets with float32), at TYPED_SHAPES (B, H,
# Hkv, Sq, Sk, D, window, causal: GQA, a window, Sq < Sk without causal,
# column chunks over D = 320, a longer sequence); negative windows (-1,
# -7: no window, as in the Pallas kernel) on each route; the float8
# layouts a model or a view gives (TYPED_LAYOUTS); and, at one key a row,
# the encoder of every narrow output and the decoder of every float8
# byte, through simt and through the tensor cores (`typed_sweeps`)
FLOAT8 = ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
          "float8_e5m2fnuz", "float8_e8m0fnu")
MIXED = (("bfloat16", "float8_e4m3fn", "float8_e4m3fn"),
         ("float32", "bfloat16", "bfloat16"),
         ("float16", "bfloat16", "float32"),
         ("float8_e5m2", "float16", "float32"),
         ("float32", "float8_e4m3fnuz", "float8_e5m2fnuz"),
         ("bfloat16", "float32", "float32"),
         ("float8_e4m3fn", "bfloat16", "bfloat16"),
         ("float16", "float8_e8m0fnu", "float8_e5m2"),
         ("float8_e8m0fnu", "float32", "float8_e8m0fnu"),
         ("float8_e4m3fnuz", "float8_e4m3fnuz", "bfloat16"),
         ("bfloat16", "bfloat16", "float8_e5m2fnuz"),
         ("float16", "float8_e5m2", "float8_e5m2"),
         ("float8_e4m3fn", "float16", "float16"),
         # the tf32 sets: bfloat16 beside float16, float16 beside e8m0fnu
         # (with or without other float8 formats), no float32
         ("bfloat16", "float16", "float16"),
         ("float16", "bfloat16", "bfloat16"),
         ("float16", "float16", "bfloat16"),
         ("bfloat16", "float16", "float8_e4m3fn"),
         ("float8_e5m2fnuz", "bfloat16", "float16"),
         ("float16", "float8_e8m0fnu", "float8_e8m0fnu"),
         ("float8_e8m0fnu", "float16", "float16"))
TYPED_SHAPES = ((1, 4, 2, 192, 192, 64, 100, True),
                (2, 8, 2, 300, 300, 128, 0, True),
                (1, 4, 4, 100, 257, 40, 0, False),
                (2, 4, 1, 130, 130, 320, 64, True),
                (1, 32, 8, 1024, 1024, 128, 0, True))
NEGATIVE_WINDOWS = (-1, -7)
NEGATIVE_WINDOW_TYPES = (("bfloat16",) * 3, ("float16",) * 3,
                         ("float32",) * 3, ("float8_e4m3fn",) * 3,
                         ("bfloat16", "float8_e4m3fn", "float8_e4m3fn"))
# float8 q, k, v as (B,H,S,D) views of (B,S,H,D) tensors (16-byte copies),
# one byte past an aligned start and with a column stride of 2 (element
# by element)
TYPED_LAYOUTS = (True, "off1", "col2")


# float32 sums taken in another order: the simt kernels' unrounded output
# lies within this share of |v|_P (the P-weighted mean of |v| along the
# row) of the plain version's; measured below 2^-20 at phase 7's shapes on
# an H100 (max abs err 1.0e-6 at |v|_P about 0.8)
F32_ORDER_TOL = 2.0 ** -16
# the tensor-core kernels round P to their compute type C before P V (the
# row sums take it unrounded): each weight moves by at most C's unit
# roundoff (2^-8 bfloat16, 2^-11 float16 and tf32, whose 10-bit mantissa
# is float16's; the tf32 kernel rounds to nearest, ties away), so the
# unrounded output by at most that share of |v|_P; u_C covers it, with
# the slack that check_flash_scaled documents for float16 and tf32 (and
# the float32 sums' order)
P_ROUND_TOL = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -10,
               "tf32": 2.0 ** -10}


def check_typed(torch, fa, ref, got, q, k, v, causal=True,
                window=0) -> dict:
    """The kernel's output `got` on q, k, v against the plain version's,
    element by element: `got` must be the rounding to its type of some x
    within tol |v|_P of the plain version's float32 output x0, where tol
    is F32_ORDER_TOL on the simt kernels (they round nothing before the
    output and sum in float32 as the plain version does) and u_C =
    P_ROUND_TOL[C] on the wgmma, wgmma_tf32 and mma kernels (they round P
    to their compute type C before P V).  As rounding is monotone, that is a value
    between the roundings of x0 -/+ that margin, or NaN where one of them
    is NaN (float8_e8m0fnu at x <= 0): exactly the plain version's output
    but within the kernel's own error of a rounding boundary, for every
    output type (float32 too, where it is |got - x0| <= the margin)."""
    name = fa.route(q, k, v)
    tol = F32_ORDER_TOL if name == "simt" else P_ROUND_TOL[str(
        fa.compute_type(q.dtype, k.dtype, v.dtype)).removeprefix("torch.")]
    dq = ref.decode(q)            # exact: the plain version in float32
    x0 = ref.flash_attention_ref(dq, k, v, causal=causal, window=window)
    margin = tol * ref.flash_attention_ref(
        dq, k, ref.decode(v).abs(), causal=causal, window=window)
    lo = ref.decode(ref.round_to(x0 - margin, got.dtype))
    hi = ref.decode(ref.round_to(x0 + margin, got.dtype))
    g = ref.decode(got)
    inside = ((g >= torch.where(torch.isnan(lo), -math.inf, lo))
              & (g <= torch.where(torch.isnan(hi), math.inf, hi)))
    ok = torch.where(torch.isnan(g), torch.isnan(lo) | torch.isnan(hi),
                     inside & ~torch.isnan(x0))
    want = ref.decode(ref.round_to(x0, got.dtype))
    both = ~(torch.isnan(g) | torch.isnan(want))
    out = {"variant": name, "tol": tol, "outside": int((~ok).sum()),
           "max_abs_err": float((g - want).abs().masked_fill(~both, 0)
                                .max())}
    if got.dtype == torch.float32:    # the margin's use, unrounded
        out["max_err_over_margin"] = float(
            ((g - x0).abs() / margin.clamp_min(1e-30)).max())
    out["ok"] = out["outside"] == 0
    return out


def typed_sweeps(torch, fa, ref, dev) -> dict:
    """One key a row, q and k zero, so every weight is exactly 1 and the
    output is v rounded to q's type: the simt kernel's encoder for each
    narrow output type against `ref.round_to` over 2^20 random float32 bit
    patterns and float32's edges (bit for bit for float8 but the sign of
    a NaN, value for value for 16-bit), and its decoder of every float8
    byte against the table (v each of the 256 bytes, a float32 output);
    then the same through the tensor cores (`tc_sweeps`)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randint(-2 ** 31, 2 ** 31, (4096 * 256,), dtype=torch.int64,
                      generator=g, device=dev).to(torch.int32).view(
                          torch.float32)
    x[:10] = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1e-45,
                           -1e-45, 1e-39, 3.4e38, 464.0], device=dev)
    v = x.view(1, 4096, 1, 256)
    z = torch.zeros_like(v)
    out = {}
    for dname in FLOAT8 + ("bfloat16", "float16"):
        td = getattr(torch, dname)
        # q of byte 0 (0, or 2^-127 in e8m0fnu): with k zero every score is 0
        qz = torch.zeros(v.shape, dtype=torch.uint8 if td.itemsize == 1
                         else td, device=dev).view(td)
        got = fa.flash_attention(qz, z, v)
        # the sum of products starts at +0, so -0 comes out +0
        want = ref.round_to(x + 0.0, td).view(got.shape)
        torch.cuda.synchronize()
        steps = ref.rounding_steps(got, want)
        # bit for bit but NaN, whose sign the products need not keep
        nan = torch.isnan(ref.decode(want))
        exact = bool(torch.equal(ref.bits(got).masked_fill(nan, 0),
                                 ref.bits(want).masked_fill(nan, 0)))
        if steps or (td.itemsize == 1 and not exact):
            raise AssertionError(f"the kernel rounds to {dname} unlike the "
                                 f"plain version: {steps} steps apart")
        out[dname] = {"values": x.numel(), "bit_exact": exact}
    for dname in FLOAT8:
        codes = torch.arange(256, dtype=torch.uint8, device=dev).view(
            getattr(torch, dname))
        zz = torch.zeros((1, 8, 1, 32), device=dev)
        got = fa.flash_attention(zz, zz, codes.view(1, 8, 1, 32)).reshape(-1)
        want = ref.decode_table(codes.dtype, dev)
        torch.cuda.synchronize()
        if not torch.equal(got.nan_to_num(0.5), want.nan_to_num(0.5)):
            raise AssertionError(f"the kernel decodes {dname} unlike the "
                                 "table")
        out[dname]["decoded"] = 256
    out["tensor_cores"] = tc_sweeps(torch, fa, ref, dev)
    return out


def tc_sweeps(torch, fa, ref, dev) -> dict:
    """`typed_sweeps` through the wgmma kernel (D=32, one key a row, every
    weight exactly 1).  Decoder: q bfloat16 zeros, k zeros and v the 256
    bytes of each float8 format F: the bfloat16 output must be the
    table's value of each byte, bit for bit (NaN as NaN; -0 comes out +0,
    the sum of products starting at +0); the same with q float16 for the
    four formats float16 holds.  Encoder: q and k zeros in F, v all 65,536
    bfloat16 bit patterns: the output in F must be `ref.round_to(v, F)`
    bit for bit but the sign of a NaN.  A value the tensor cores flushed
    (a subnormal of bfloat16 or float16, as e8m0fnu's byte 0 and e5m2's
    smallest are) breaks the sweep."""
    out, before = {}, dict(fa.DTYPE_LAUNCHES)

    def zeros(shape, td):
        return torch.zeros(shape, dtype=torch.uint8, device=dev).view(td) \
            if td.itemsize == 1 else torch.zeros(shape, dtype=td, device=dev)

    def same_bits(got, want):
        nan = torch.isnan(ref.decode(want))
        return bool(torch.equal(torch.isnan(ref.decode(got)), nan)
                    and torch.equal(ref.bits(got).masked_fill(nan, 0),
                                    ref.bits(want).masked_fill(nan, 0)))

    for dname in FLOAT8:
        td = getattr(torch, dname)
        codes = torch.arange(256, dtype=torch.uint8, device=dev).view(td)
        table = ref.decode_table(td, dev) + 0.0          # -0 as +0
        for cname in ("bfloat16", "float16"):
            cd = getattr(torch, cname)
            if fa.compute_type(cd, td, td) is None:
                continue                   # float16 cannot hold e8m0fnu
            q, k = zeros((1, 8, 1, 32), cd), zeros((1, 8, 1, 32), td)
            v = codes.view(1, 8, 1, 32)
            got = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            if not same_bits(got.reshape(-1), table.to(cd)):
                raise AssertionError(f"the {fa.route(q, k, v)} kernel "
                                     f"decodes {dname} into {cname} unlike "
                                     "the table")
            out[f"{dname}->{cname}"] = 256
        v = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(
            torch.int16).view(torch.bfloat16).view(1, 2048, 1, 32)
        qz = zeros((1, 2048, 1, 32), td)
        got = fa.flash_attention(qz, qz, v)
        want = ref.round_to(v.float() + 0.0, td)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            bad = int((ref.bits(got) != ref.bits(want)).sum())
            raise AssertionError(f"the tensor cores' output rounds to "
                                 f"{dname} unlike the plain version: {bad} "
                                 "of 65,536 bfloat16 patterns")
        out[f"bfloat16->{dname}"] = 65536
    out.update(tf32_sweeps(torch, fa, ref, dev, zeros, same_bits))
    out["dtype_launches"] = {k: n - before.get(k, 0)
                             for k, n in fa.DTYPE_LAUNCHES.items()
                             if n != before.get(k, 0)}
    if any(not k.startswith(("wgmma/", "wgmma_tf32/"))
           for k in out["dtype_launches"]):
        raise AssertionError(f"a sweep left the tensor cores: "
                             f"{out['dtype_launches']}")
    return out


def tf32_sweeps(torch, fa, ref, dev, zeros, same_bits) -> dict:
    """`tc_sweeps` through the tf32 kernel (D=32, one key a row, every
    weight exactly 1: q zeros, so every score is 0 whatever k holds).
    Decoder: v each of the 256 bytes of each float8 format, q bfloat16
    and k float16 (tf32: bfloat16 beside float16): the bfloat16 output
    must be the table's value bit for bit (every float8 value is one of
    bfloat16's; -0 comes out +0, the sum starting at +0); q float16 and k
    e8m0fnu: the float16 output must be the plain version's rounding of
    the table.  Then v every bfloat16 pattern (q bfloat16, k float16) and
    every float16 pattern (q float16, k bfloat16): the output must be v
    bit for bit, subnormals included, bfloat16's being float32
    subnormals in tf32: a tensor core that flushed them, or e8m0fnu's
    2^-127, breaks the sweep.  Encoder: q zeros in each float8 format F, k
    bfloat16, v every float16 pattern: the output in F must be
    `ref.round_to(v, F)` bit for bit but the sign of a NaN.  Every launch
    must be the tf32 kernel's."""
    out, before = {}, dict(fa.DTYPE_LAUNCHES)
    bf, hf, e8 = torch.bfloat16, torch.float16, torch.float8_e8m0fnu
    shape = (1, 8, 1, 32)
    for dname in FLOAT8:
        td = getattr(torch, dname)
        codes = torch.arange(256, dtype=torch.uint8, device=dev).view(td)
        table = ref.decode_table(td, dev) + 0.0          # -0 as +0
        v = codes.view(shape)
        for q, k in ((zeros(shape, bf), zeros(shape, hf)),
                     (zeros(shape, hf), zeros(shape, e8))):
            got = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            if not same_bits(got.reshape(-1), ref.round_to(table, q.dtype)):
                raise AssertionError(
                    f"the {fa.route(q, k, v)} kernel decodes {dname} with "
                    f"q {q.dtype}, k {k.dtype} unlike the table")
        out[f"{dname}->tf32"] = 256
    big = (1, 2048, 1, 32)
    pats = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(
        torch.int16)
    for vd, qd, kd in ((bf, bf, hf), (hf, hf, bf)):
        v = pats.view(vd).view(big)
        got = fa.flash_attention(zeros(big, qd), zeros(big, kd), v)
        torch.cuda.synchronize()
        if not same_bits(got, ref.round_to(v.float() + 0.0, qd)):
            bad = int((ref.bits(got) != ref.bits(v)).sum())
            raise AssertionError(f"the tf32 kernel passes {vd} values "
                                 f"unlike the plain version: {bad} of "
                                 f"65,536 patterns")
        out[f"{str(vd).removeprefix('torch.')}->tf32"] = 65536
    v = pats.view(hf).view(big)
    for dname in FLOAT8:
        td = getattr(torch, dname)
        got = fa.flash_attention(zeros(big, td), zeros(big, bf), v)
        want = ref.round_to(v.float() + 0.0, td)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            bad = int((ref.bits(got) != ref.bits(want)).sum())
            raise AssertionError(f"the tf32 kernel's output rounds to "
                                 f"{dname} unlike the plain version: {bad} "
                                 "of 65,536 float16 patterns")
        out[f"float16->{dname} (tf32)"] = 65536
    ran = {k: n - before.get(k, 0) for k, n in fa.DTYPE_LAUNCHES.items()
           if n != before.get(k, 0)}
    if any(not k.startswith("wgmma_tf32/") for k in ran):
        raise AssertionError(f"a tf32 sweep left the tf32 kernel: {ran}")
    return out


def check_flash_types(torch, fa, ref, dev) -> dict:
    """Phase 7, the other types: every float8 format and each MIXED
    combination at TYPED_SHAPES, both negative windows on every route
    (against the plain version at window 0), the float8 TYPED_LAYOUTS,
    and `typed_sweeps`; each held element by element (`check_typed`)
    against the plain version on the card, each launch counted by its
    four types.  `max_err` is the largest absolute difference from the
    plain version's output for each combination, `margin_use` the largest
    unrounded float32 error over its margin (simt, float32 output)."""
    before = dict(fa.DTYPE_LAUNCHES)
    combos = [(d,) * 3 for d in FLOAT8] + list(MIXED)
    cases = [(combo, shape, False, None) for combo in combos
             for shape in TYPED_SHAPES]
    cases += [(combo, (2, 8, 2, 300, 300, D, w, True), False, w)
              for combo in NEGATIVE_WINDOW_TYPES for D in (64, 100)
              for w in NEGATIVE_WINDOWS]
    cases += [((d, d, "bfloat16"), (2, 4, 2, 192, 257, 64, 100, True),
               layout, None)
              for d in ("float8_e4m3fn", "float8_e5m2") for layout in
              TYPED_LAYOUTS]
    worst, margin_use, expected = {}, 0.0, {}
    for i, (combo, shape, layout, neg) in enumerate(cases):
        B, H, Hkv, Sq, Sk, D, w, c = shape
        dts = tuple(getattr(torch, d) for d in combo)
        q, k, v = qkv(torch, B, H, Hkv, Sq, Sk, D, dts, 1000 + i, dev,
                      layout)
        key = fa.dtype_key(fa.route(q, k, v), *dts, dts[0])
        expected[key] = expected.get(key, 0) + 1
        got = fa.flash_attention(q, k, v, causal=c, window=w)
        check = check_typed(torch, fa, ref, got, q, k, v, causal=c,
                            window=0 if neg else w)
        if not check["ok"]:
            raise AssertionError(
                f"flash_attention {combo} {shape} layout={layout}: {check}"
                f" against the plain version")
        key = ",".join(combo) if neg is None else f"{','.join(combo)} " \
            f"window<0"
        worst[key] = max(worst.get(key, 0.0), check["max_abs_err"])
        margin_use = max(margin_use, check.get("max_err_over_margin", 0.0))
        del q, k, v, got
    # each case launched on the route `fa.route` gives it, counted by its
    # four types (before the sweeps, which count their own)
    ran = {k: v - before.get(k, 0) for k, v in fa.DTYPE_LAUNCHES.items()
           if v != before.get(k, 0)}
    missing = {k: n for k, n in expected.items() if ran.get(k, 0) < n}
    for name in fa.VARIANTS:           # each route took some typed set
        if not any(k.split("/")[0] == name for k in ran):
            missing[name] = "no typed launch"
    sweeps = typed_sweeps(torch, fa, ref, dev)
    out = {"cases": len(cases), "combos": len(combos),
           "max_err": worst, "margin_use": margin_use,
           "dtype_launches": ran, "sweeps": sweeps}
    emit("kernel_check_types", kernel="flash_attention", **out)
    if missing:
        raise AssertionError(f"cases that did not launch on their route: "
                             f"{missing} (ran {ran})")
    return out


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


def check_flash_scaled(torch, ref, got, want, q, k, v, causal=True,
                       window=0, scale=None) -> dict:
    """The kernel's output `got` vs the plain version's `want` on q, k, v
    at a prefill shape, held element by element to
    r (|want| + |v|_P / 2) + a, where |v|_P is the plain version run on
    |v| (the P-weighted mean of |v| along the row) and r, a are q's type's
    FLASH_REL_TOL and FLASH_ABS_TOL.  In bf16 (r = 2^-7) r |want| covers
    the rounding of both outputs and r/2 |v|_P bounds the kernel's
    rounding of P to bf16 before PV (2^-9 a weight, with slack); float16
    is the same at 2^-9, its rounding being 4 times finer.  At S=4096 a
    typical bf16 output is 0.03-0.04 and this limit about 3.5e-3, where a
    fixed 2e-2 would pass a dropped or repeated KV tile.  `scale` is the
    softmax scale both were run with (None: 1/sqrt(D))."""
    dname = str(q.dtype).removeprefix("torch.")
    want = want.float()
    weighted = ref.flash_attention_ref(q, k, ref.decode(v).abs(),
                                       causal=causal, window=window,
                                       scale=scale).float()
    err = (got.float() - want).abs()
    mag = want.abs()
    limit = (FLASH_REL_TOL[dname] * (mag + weighted / 2)
             + FLASH_ABS_TOL[dname])
    ratio = float((err / limit).max())
    return {"max_abs_err": float(err.max()),
            "mean_abs_want": float(mag.mean()),
            "mean_limit": float(limit.mean()),
            "max_err_over_mean_want": float(err.max() / mag.mean()),
            "worst_over_limit": ratio}


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
    """K3 at FLASH_TIMED's shapes.  At each shape the kernel's output is
    held against the plain version's on the same inputs
    (check_flash_scaled), then the kernel (on contiguous inputs, and on
    the strided (B,S,H,D) views the model passes), the plain version and
    the library call (scaled_dot_product_attention in the same dtype, a
    yardstick only) are timed."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    clock = sm_clock_mhz()
    out = {}
    for name, dname, B, H, Hkv, S, D, reps in FLASH_TIMED:
        q, k, v = qkv(torch, B, H, Hkv, S, S, D, getattr(torch, dname), 7,
                      dev)
        check = check_flash_scaled(torch, ref, fa.flash_attention(q, k, v),
                                   ref.flash_attention_ref(q, k, v), q, k, v)
        emit("kernel_check", kernel="flash_attention", shape=name,
             dtype=dname, B=B, S=S, D=D, **check)
        if not check["worst_over_limit"] <= 1.0:
            raise AssertionError(f"flash_attention at {name} (B={B}, S={S})"
                                 f" differs from its plain version: {check}")
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
                     "check": check, "flops": cost["flops"],
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
    """K3 at FLASH_TYPED_TIMED: the kernel held against its plain version
    element by element (`check_typed`), then both timed beside the card's
    bound (the products at the rate of the widest input type: float8's
    where all are float8) and the design's (`design_bound_ms`: the
    products at the rate of the route that runs them, DESIGN_RATE), and
    SDPA in float32 where all three are float32.  Run on an older tree
    (the same file copied there), it times that tree's kernels."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    clock = sm_clock_mhz()
    out = {}
    for name, names, B, H, Hkv, S, D, reps in FLASH_TYPED_TIMED:
        dts = tuple(getattr(torch, n) for n in names)
        q, k, v = qkv(torch, B, H, Hkv, S, S, D, dts, 7, dev)
        got = fa.flash_attention(q, k, v)
        check = check_typed(torch, fa, ref, got, q, k, v)
        emit("kernel_check", kernel="flash_attention", shape=name,
             dtypes=names, B=B, S=S, D=D, **check)
        if not check["ok"]:
            raise AssertionError(f"flash_attention at {name} differs from "
                                 f"its plain version: {check}")
        del got
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
                     "width": fa.width(variant, D), "check": check,
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


def check_large_rows(torch, parity, ref, dev) -> dict:
    """Phase 3's largest shape, the parity call of the biggest leaf of the
    phase-12 checkpoint (the (vocab, d) embedding and its moments): K=3
    rows of 518,782,976 bytes.  The kernel against its plain version bit
    for bit, every row reconstructed from the other two and the parity;
    then both timed, beside the bound."""
    cfg = train_config().model
    n = leaf_row_lanes(cfg.vocab * cfg.d_model * 4)
    x = rows(torch, TRAIN_STRIPES, n, 99, dev)
    p = parity.xor_parity(x)
    want = ref.xor_parity_ref(x)
    torch.cuda.synchronize()
    worst = max_abs_err(torch, p, want)
    if not torch.equal(p, want):
        raise AssertionError(f"xor_parity K=3 N={n} differs from the plain "
                             "version")
    for miss in range(TRAIN_STRIPES):
        got = parity.reconstruct([x[i] for i in range(TRAIN_STRIPES)
                                  if i != miss], p)
        torch.cuda.synchronize()
        if not torch.equal(got, x[miss]):
            raise AssertionError(f"reconstruct K=3 N={n} row {miss} differs")
    del want, got
    kern = time_on_card(torch, parity.xor_parity, [x], reps=5)
    plain = time_on_card(torch, ref.xor_parity_ref, [x], reps=5)
    b, by = bound_ms(TRAIN_STRIPES, n)
    out = {"K": TRAIN_STRIPES, "N": n, "max_abs_err": worst,
           "bit_exact": True, "ms": kern["graph_ms"],
           "plain_ms": plain["graph_ms"], "bound_ms": b, "bound_by": by,
           "bound_share": b / kern["graph_ms"],
           "typed": large_typed_rows(torch, parity, ref, dev, 4 * n)}
    emit("kernel_check_large", kernel="xor_parity", **out)
    del x, p
    torch.cuda.empty_cache()
    return out


def large_typed_rows(torch, parity, ref, dev, row_bytes) -> dict:
    """K1 on INT_TIMED's narrow and wide rows (uint8, int64) at the bytes
    of phase 12's largest call, K=3 rows of `row_bytes`, where no launch
    cost hides the kernel: bit for bit against the plain version, then
    both timed beside the byte bound (the rows read once, N int32 lanes
    written once)."""
    out = {}
    for dname in INT_TIMED:
        n = row_bytes // getattr(torch, dname).itemsize
        x = int_rows(torch, TRAIN_STRIPES, n, dname, 101, dev)
        got = parity.xor_parity(x)
        same = torch.equal(got, ref.xor_parity_ref(x))
        torch.cuda.synchronize()
        if not same:
            raise AssertionError(f"xor_parity {dname} K={TRAIN_STRIPES} "
                                 f"N={n} differs from the plain version")
        del got
        kern = time_on_card(torch, parity.xor_parity, [x], reps=5)
        plain = time_on_card(torch, ref.xor_parity_ref, [x], reps=5)
        nbytes = TRAIN_STRIPES * row_bytes + 4 * n
        b = nbytes / HBM_BYTES_PER_S * 1e3
        out[dname] = {"K": TRAIN_STRIPES, "N": n, "bytes": nbytes,
                      "bit_exact": True, "ms": kern["graph_ms"],
                      "plain_ms": plain["graph_ms"], "bound_ms": b,
                      "bound_by": "bytes", "bound_share": b / kern["graph_ms"],
                      "library_ms": None}
        del x
        torch.cuda.empty_cache()
    return out


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


# one head dim per wgmma kernel: width 64 at 1-4 k16 steps of Q K^T; width
# 128 at 5-8; width 256 at 12 and 16
WGMMA_FIRST_DIMS = [8, 24, 40, 56, 72, 96, 112, 128, 136, 256]
# the same kernels where they decode float8: one D % 16 == 0 per width and
# step count (a float8 row of D bytes the TMA takes), and the type sets
# they take in turn, for each compute type: k and v decoded beside a
# 16-bit q, all three (a float8 output), q alone, each format
DEC_WGMMA_FIRST_DIMS = [16, 32, 48, 64, 80, 96, 112, 128, 144, 256]
DEC_FIRST_TYPES = {
    "bfloat16": (("bfloat16", "float8_e4m3fn", "float8_e4m3fn"),
                 ("float8_e4m3fn",) * 3,
                 ("float8_e8m0fnu", "bfloat16", "float8_e4m3fnuz"),
                 ("float8_e5m2fnuz", "float8_e5m2", "bfloat16")),
    "float16": (("float16", "float8_e5m2", "float8_e5m2"),
                ("float8_e4m3fn", "float16", "float16"),
                ("float8_e4m3fnuz", "float8_e5m2fnuz", "float16"))}


# the tf32 kernel at each width (D 8-64 at 64, 72-128 at 128), q of each
# kind of type it takes, float8 beside float16 and bfloat16, e8m0fnu
# beside float16
TF32_FIRST = ((("bfloat16", "float16", "float16"), 64),
              (("float16", "bfloat16", "bfloat16"), 128),
              (("float16", "float8_e8m0fnu", "float8_e5m2"), 32),
              (("float8_e4m3fn", "float16", "bfloat16"), 96),
              (("float8_e8m0fnu", "float16", "float8_e4m3fnuz"), 112))


# phase 17: the SSD kernel at the docs cell's shapes (zamba2-7b: H = 112,
# P = N = 64, chunk 256, one prompt a call) and its requests
SSD_LENGTHS = (512, 1024, 2048, 4096)
SSD_HEADS, SSD_CHUNK = 112, 256
# against `_ssd_chunked` on the card (tests/test_torch_ssd.py's limits):
# y and the final state within SSD_REL_TOL in relative Frobenius norm; y
# element by element within SSD_FLIP_TOL of max|y| (one bf16 step of an
# att_ij that the two sums of C_i . B_j round to neighbours), at most
# SSD_FLIP_SHARE of the elements past SSD_REL_TOL of max|y|
SSD_REL_TOL, SSD_FLIP_TOL, SSD_FLIP_SHARE = 1e-4, 2.0 ** -8, 1e-3


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


def ssd_check(torch, got, want) -> dict:
    """The kernel's (y, state) against the plain version's."""
    (y, st), (y_r, st_r) = got, want
    off = (y - y_r).abs()
    top = float(y_r.abs().max())
    out = {"y_rel": float((y - y_r).norm() / y_r.norm()),
           "state_rel": float((st - st_r).norm() / st_r.norm()),
           "y_max_off": float(off.max()) / top,
           "y_share_off": float((off > SSD_REL_TOL * top).float().mean()),
           "finite": bool(torch.isfinite(y).all() and
                          torch.isfinite(st).all())}
    out["ok"] = (out["finite"] and out["y_rel"] <= SSD_REL_TOL
                 and out["state_rel"] <= SSD_REL_TOL
                 and out["y_max_off"] <= SSD_FLIP_TOL
                 and out["y_share_off"] <= SSD_FLIP_SHARE)
    return out


def time_ssd(torch, dev, lengths=SSD_LENGTHS, H=SSD_HEADS, N=64,
             label="ssd") -> dict:
    """Phase 17a: at each docs length the kernel held against
    `_ssd_chunked` on the same inputs (TF32 off), then both timed
    (time_on_card: graph replays over a pool of inputs past the L2),
    beside the bound; at other `lengths`, heads `H` and state size `N`
    for phase 17c."""
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
            check = ssd_check(torch, ssd.ssd_chunked(*pool[0], SSD_CHUNK),
                              zamba2._ssd_chunked(*pool[0], SSD_CHUNK))
            emit("kernel_check", kernel=label, S=S, **check)
            if not check["ok"]:
                raise AssertionError(f"ssd kernel at S={S} differs from "
                                     f"_ssd_chunked: {check}")
            kern = time_on_card(torch, lambda t: ssd.ssd_chunked(
                *t, SSD_CHUNK), pool)
            plain = time_on_card(torch, lambda t: zamba2._ssd_chunked(
                *t, SSD_CHUNK), pool[:2], reps=5)
            out[S] = {"B": 1, "H": H, "N": N, "chunk": SSD_CHUNK,
                      "check": check, "ms": kern["graph_ms"],
                      "stream_ms": kern["stream_ms"],
                      "plain_ms": plain["graph_ms"],
                      "plain_stream_ms": plain["stream_ms"], **cost,
                      "bound_share": cost["bound_ms"] / kern["graph_ms"],
                      "sm_clock_mhz": clock}
            del pool
            torch.cuda.empty_cache()
    emit("kernel_time", kernel=label, times=out)
    return out


# phase 17c: the SSD kernel at Granite 4.0-H Small's state size (N = 128,
# H = 128) beside zamba2's (N = 64, H = 112), a block a call
SSD_SIZE_LENGTHS = (2048, 4096, 6144, 8192)
GRANITE_SSD_HEADS = 128


def time_ssd_sizes(torch, dev) -> dict:
    """Phase 17c: time_ssd at N = 128 and at N = 64 over
    SSD_SIZE_LENGTHS."""
    return {"n128": time_ssd(torch, dev, SSD_SIZE_LENGTHS, GRANITE_SSD_HEADS,
                             128, "ssd_n128"),
            "n64": time_ssd(torch, dev, SSD_SIZE_LENGTHS, SSD_HEADS, 64,
                            "ssd_n64")}


def ssd_requests(torch, dev, rounds=3) -> dict:
    """Phase 17b: `rounds` x SSD_LENGTHS docs requests (12) through
    build_prefill_step on zamba2-7b whole (bf16 parameters from SEED,
    chunk 256, flash), tracer on: each launches the SSD kernel once a
    Mamba2 block (81) and runs `_ssd_chunked` in none; then the same
    requests with the plain version forced (a route that refuses all),
    which count 81 each in `ssd.chunked`.  Per length, the median wall
    time of a request (the call to the next token on the host) on each
    route, and whether the two routes serve the same token."""
    from repro_torch import trace
    from repro_torch.configs import zamba2_7b
    from repro_torch.kernels import ssd
    from repro_torch.models import layers, registry
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import build_prefill_step

    cfg = zamba2_7b.CONFIG
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = layers.tree_init(registry.param_defs(cfg), gen, torch.bfloat16)
    steps = {S: build_prefill_step(cfg, RunConfig(
        seq_len=S, global_batch=1, kind="prefill", param_dtype="bfloat16",
        attn_impl="flash", ssm_chunk=SSD_CHUNK), device=dev)
        for S in SSD_LENGTHS}
    toks = {S: torch.randint(0, cfg.vocab, (1, S), generator=gen,
                             device=dev, dtype=torch.int32)
            for S in SSD_LENGTHS}
    order = [S for _ in range(rounds) for S in SSD_LENGTHS]
    route = ssd.route

    def serve():
        for S in SSD_LENGTHS:                      # warm each length
            steps[S](params, {"tokens": toks[S]})
        torch.cuda.synchronize()
        trace.reset()
        trace.enable()
        walls, kept = {S: [] for S in SSD_LENGTHS}, {}
        try:
            for S in order:
                t = time.perf_counter()
                tok, _ = steps[S](params, {"tokens": toks[S]})
                int(tok[0, 0])
                walls[S].append(time.perf_counter() - t)
                kept[S] = tok
            counts = trace.counters()
        finally:
            trace.disable()
            trace.reset()
        return {"ms": {S: statistics.median(w) * 1e3
                       for S, w in walls.items()},
                "launches": counts.get("ssd.launches", 0),
                "chunked": counts.get("ssd.chunked", 0)}, kept

    kern, got = serve()
    try:
        ssd.route = lambda *a: "forced"
        plain, want = serve()
    finally:
        ssd.route = route
    blocks = cfg.n_layers * len(order)
    same = {S: bool(torch.equal(got[S], want[S])) for S in SSD_LENGTHS}
    out = {"requests": len(order), "blocks": blocks, "kernel": kern,
           "plain": plain, "same_token": same}
    emit("ssd_requests", **out)
    if (kern["launches"], kern["chunked"]) != (blocks, 0) or \
            (plain["launches"], plain["chunked"]) != (0, blocks):
        raise AssertionError(f"ssd launches {kern['launches']}, chunked "
                             f"{kern['chunked']} for {blocks} blocks; forced "
                             f"plain: {plain['launches']}, "
                             f"{plain['chunked']}")
    del params
    free(torch, dev)
    return out


# K3 as Granite 4.0-H Small's attention layers call it: H, Hkv, D and the
# softmax scale (attention_multiplier, 1/128 where 1/sqrt(D) would be
# 1/11.3)
GRANITE_ATTN = (32, 8, 128, 0.0078125)


def check_granite_attention(torch, fa, ref, dev) -> dict:
    """Phase 17c: K3 as `transformer._flash` calls it in Granite 4.0-H
    Small (bf16, causal, GRANITE_ATTN, on the strided (B,S,H,D) views)
    at S in SSD_SIZE_LENGTHS, held element by element against the plain
    version with the same scale (check_flash_scaled)."""
    H, Hkv, D, scale = GRANITE_ATTN
    out = {}
    for S in SSD_SIZE_LENGTHS:
        q, k, v = qkv(torch, 1, H, Hkv, S, S, D, torch.bfloat16, S, dev,
                      strided=True)
        name = fa.route(q, k, v)
        check = check_flash_scaled(
            torch, ref, fa.flash_attention(q, k, v, scale=scale),
            ref.flash_attention_ref(q, k, v, scale=scale), q, k, v,
            scale=scale)
        emit("kernel_check", kernel="flash_attention", shape="granite",
             S=S, scale=scale, variant=name, **check)
        if not check["worst_over_limit"] <= 1.0:
            raise AssertionError(f"flash_attention at Granite's shape, "
                                 f"S={S}, scale {scale}, differs from its "
                                 f"plain version: {check}")
        out[S] = {"variant": name, **check}
        del q, k, v
    return out


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


def granite_requests(torch, fa, dev) -> dict:
    """Phase 17c: a request of each length in SSD_SIZE_LENGTHS through
    build_prefill_step on Granite 4.0-H Small whole (bf16_params, chunk
    256, flash), each length warmed first; the kernels' launch counts set
    to 0 just before the requests, then each request launches the SSD
    kernel once a Mamba2 layer (36), K3 once an attention layer (4), and
    runs `_ssd_chunked` in none (`ssd.chunked`, tracer on)."""
    from repro_torch import trace
    from repro_torch.configs import granite4_h_small
    from repro_torch.kernels import ssd
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import build_prefill_step

    cfg = granite4_h_small.CONFIG
    params = bf16_params(torch, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    steps, toks = {}, {}
    for S in SSD_SIZE_LENGTHS:
        steps[S] = build_prefill_step(cfg, RunConfig(
            seq_len=S, global_batch=1, kind="prefill",
            param_dtype="bfloat16", attn_impl="flash",
            ssm_chunk=SSD_CHUNK), device=dev)
        toks[S] = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                                device=dev, dtype=torch.int32)
        steps[S](params, {"tokens": toks[S]})
    torch.cuda.synchronize()
    mamba = cfg.layer_types.count("mamba")
    want = {"ssd": mamba, "flash": cfg.n_layers - mamba}
    trace.reset()
    trace.enable()
    ssd.LAUNCHES = fa.LAUNCHES = 0
    per = {}
    try:
        for S in SSD_SIZE_LENGTHS:
            s0, f0 = ssd.LAUNCHES, fa.LAUNCHES
            t = time.perf_counter()
            tok, _ = steps[S](params, {"tokens": toks[S]})
            int(tok[0, 0])
            per[S] = {"ms": (time.perf_counter() - t) * 1e3,
                      "ssd": ssd.LAUNCHES - s0, "flash": fa.LAUNCHES - f0}
        chunked = trace.counters().get("ssd.chunked", 0)
    finally:
        trace.disable()
        trace.reset()
    out = {"requests": per, "chunked": chunked, "want": want,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}
    emit("granite_requests", **out)
    del params, steps
    free(torch, dev)
    if chunked or any({k: r[k] for k in want} != want for r in per.values()):
        raise AssertionError(f"granite launches {per}, chunked {chunked}; "
                             f"{want} a request wanted")
    return out


def ssd_phase(torch, dev) -> dict:
    """Phase 17: time_ssd, ssd_requests, then time_ssd_sizes,
    check_granite_attention and granite_requests (17c)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    return {"times": time_ssd(torch, dev),
            "requests": ssd_requests(torch, dev),
            "sizes": time_ssd_sizes(torch, dev),
            "granite_attention": check_granite_attention(torch, fa, ref,
                                                         dev),
            "granite_requests": granite_requests(torch, fa, dev)}


# phase 18: the MoE's row kernels (`kernels.moe_rows`, csrc/moe_rows.cu)
# at Granite 4.0-H Small's routing (72 experts, top-10) and the chat
# cell's phi3.5-moe (16, top-2), d = 4096, a layer a call
MOE_ROWS_SHAPES = {"granite": (72, 10, (2048, 4096, 6144, 8192)),
                   "chat": (16, 2, (128, 512, 1024, 2048, 4096, 8192))}
MOE_ROWS_D = 4096
CHAT_LENGTHS = (128, 1024, 4096, 8192)


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


def ulps16(torch, a, b):
    """|a - b| in units in the last place of a 16-bit type, elementwise
    (each bit pattern as an ordered integer)."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


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


def check_moe_rows(torch, dev) -> dict:
    """Phase 18a/b: at each shape of MOE_ROWS_SHAPES the kernels against
    `_scatter` (the buffer equal to the bit, from the same `keep`) and
    `_combine` (y within one unit in the last place: the kernel sums the
    slots in order, `_combine`'s reduction in another), against their
    plain versions (bit for bit: the same products summed in the same
    order) and against themselves on a repeat; then each timed
    (time_on_card, graph replays over a pool past the L2) beside its bound
    and beside `_scatter` / `_combine`."""
    from repro_torch.kernels import moe_rows
    from repro_torch.models import moe
    bf16 = torch.bfloat16
    out = {}
    with torch.no_grad():
        for name, (E, k, lengths) in MOE_ROWS_SHAPES.items():
            for T in lengths:
                cfg, C, x, top_p, order, dest, keep, eo = moe_rows_inputs(
                    torch, E, k, T, SEED + T, dev)
                launches = moe_rows.LAUNCHES
                buf, slot_row = moe_rows.dispatch_rows(x, order, dest, E, C,
                                                       k)
                y = moe_rows.combine_rows(eo, slot_row, top_p)
                y2 = moe_rows.combine_rows(eo, slot_row, top_p)
                torch.cuda.synchronize()
                ran = moe_rows.LAUNCHES - launches
                buf_p, slot_p = moe_rows.dispatch_rows_plain(x, order, dest,
                                                             E, C, k)
                y_p = moe_rows.combine_rows_plain(eo, slot_row, top_p)
                want_buf = moe._scatter(x, order, dest, E, C, k, bf16)
                want = moe._combine(eo, dest, order, top_p, k)
                off = ulps16(torch, y, want)
                kept = int(keep.sum())
                check = {
                    "buffer_equal": bool(torch.equal(buf, want_buf)),
                    "slot_row_equal": bool(torch.equal(slot_row, slot_p)),
                    "plain_buffer_equal": bool(torch.equal(buf, buf_p)),
                    "y_equal_plain": bool(torch.equal(y, y_p)),
                    "y_repeat_equal": bool(torch.equal(y, y2)),
                    "y_max_ulps": int(off.max()),
                    "y_share_off": float((off > 0).float().mean()),
                    "launches": ran, "dropped_share": 1 - kept / (T * k)}
                check["ok"] = (check["buffer_equal"]
                               and check["slot_row_equal"]
                               and check["plain_buffer_equal"]
                               and check["y_equal_plain"]
                               and check["y_repeat_equal"]
                               and check["y_max_ulps"] <= 1 and ran == 3)
                emit("kernel_check", kernel="moe_rows", shape=name, E=E,
                     k=k, T=T, C=C, **check)
                if not check["ok"]:
                    raise AssertionError(f"moe_rows at {name} T={T} differs "
                                         f"from the plain path: {check}")
                del buf, buf_p, want_buf, y, y2, y_p, want
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
                row = {"E": E, "k": k, "T": T, "C": C, "check": check,
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


def moe_requests(torch, cfg, params, lengths, dev, tag) -> dict:
    """Phase 18c/d: a request of each of `lengths` through
    build_prefill_step (bf16, chunk 256, flash), each warmed first, tracer
    on, with the MoE on the row kernels and then on `_scatter`/`_combine`
    (`moe_rows.route` forced to refuse): each request's counts of
    `moe.kernel`, `moe.plain` and the wrappers' launches, its wall time,
    and the gap between the two routes' logits at the last position
    (largest difference over the largest logit) and their tokens."""
    from repro_torch import trace
    from repro_torch.kernels import moe_rows
    from repro_torch.models import registry
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import build_prefill_step

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rcs, steps, toks = {}, {}, {}
    for S in lengths:
        rcs[S] = RunConfig(seq_len=S, global_batch=1, kind="prefill",
                           param_dtype="bfloat16", attn_impl="flash",
                           ssm_chunk=SSD_CHUNK)
        steps[S] = build_prefill_step(cfg, rcs[S], device=dev)
        toks[S] = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                                device=dev, dtype=torch.int32)
        steps[S](params, {"tokens": toks[S]})
    torch.cuda.synchronize()

    def serve():
        per, logits = {}, {}
        for S in lengths:
            trace.reset()
            trace.enable()
            launches = moe_rows.LAUNCHES
            try:
                t = time.perf_counter()
                tok, _ = steps[S](params, {"tokens": toks[S]})
                int(tok[0, 0])
                ms = (time.perf_counter() - t) * 1e3
                counts = trace.counters()
                launched = moe_rows.LAUNCHES - launches
            finally:
                trace.disable()
                trace.reset()
            with torch.no_grad():
                x, *_ = registry.forward(cfg, params, {"tokens": toks[S]},
                                         rcs[S])
                logits[S] = registry.unembed(cfg, params, x[:, -1:],
                                             rcs[S]).float()
            per[S] = {"ms": ms, "moe.kernel": counts.get("moe.kernel", 0),
                      "moe.plain": counts.get("moe.plain", 0),
                      "launches": launched}
        return per, logits

    kern, got = serve()
    route = moe_rows.route
    try:
        moe_rows.route = lambda *a: "forced"
        plain, want = serve()
    finally:
        moe_rows.route = route
    moe_layers = cfg.n_layers
    gaps = {S: {"gap": float((got[S] - want[S]).abs().max()
                             / want[S].abs().max()),
                "same_token": bool(torch.equal(got[S].argmax(-1),
                                               want[S].argmax(-1)))}
            for S in lengths}
    out = {"layers": moe_layers, "kernel": kern, "plain": plain,
           "logits": gaps,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}
    emit("moe_requests", model=tag, **out)
    bad = [S for S in lengths
           if (kern[S]["moe.kernel"], kern[S]["moe.plain"],
               kern[S]["launches"]) != (moe_layers, 0, 2 * moe_layers)
           or (plain[S]["moe.kernel"], plain[S]["moe.plain"],
               plain[S]["launches"]) != (0, moe_layers, 0)]
    if bad:
        raise AssertionError(f"{tag} requests at {bad}: {kern} on the "
                             f"kernels, {plain} forced plain; {moe_layers} "
                             f"MoE layers a request")
    return out


def moe_train_counts(torch, dev) -> dict:
    """Phase 18e: a training forward and backward of phi3.5-moe at full
    width, 2 layers (bf16 parameters that need gradients, 1 x 1024
    tokens), tracer on: every MoE layer takes `_scatter`/`_combine`
    (`moe.kernel` 0, `moe.plain` 2) and the wrappers launch nothing."""
    from repro_torch import trace
    from repro_torch.configs import phi35_moe
    from repro_torch.kernels import moe_rows
    from repro_torch.models import layers
    from repro_torch.models.config import RunConfig
    from repro_torch.train import steps

    cfg = phi35_moe.CONFIG.scaled(n_layers=2)
    params = bf16_params(torch, cfg, dev, SEED + 18)
    leaves = [t.requires_grad_() for _, t in layers.tree_items(params)]
    rc = RunConfig(seq_len=1024, global_batch=1, kind="train",
                   param_dtype="bfloat16", compute_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab, (1, rc.seq_len), generator=gen,
                         device=dev, dtype=torch.int64)
    launches = moe_rows.LAUNCHES
    trace.reset()
    trace.enable()
    try:
        loss = steps.loss_fn(cfg, params, {"tokens": toks, "labels": toks},
                             rc)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        counts = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    out = {"layers": cfg.n_layers, "loss": float(loss.detach()),
           "finite_grads": all(bool(torch.isfinite(g).all()) for g in grads),
           "moe.kernel": counts.get("moe.kernel", 0),
           "moe.plain": counts.get("moe.plain", 0),
           "launches": moe_rows.LAUNCHES - launches}
    emit("moe_train_counts", **out)
    del params, leaves, grads, loss
    free(torch, dev)
    if (out["moe.kernel"], out["moe.plain"], out["launches"]) != (
            0, cfg.n_layers, 0) or not out["finite_grads"]:
        raise AssertionError(f"training step: {out}")
    return out


def moe_rows_phase(torch, dev) -> dict:
    """Phase 18: check_moe_rows, then the requests of Granite 4.0-H Small
    whole (SSD_SIZE_LENGTHS) and of the chat cell's phi3.5-moe stage (16
    layers, CHAT_LENGTHS), then moe_train_counts."""
    from repro_torch.configs import granite4_h_small, phi35_moe
    out = {"kernels": check_moe_rows(torch, dev)}
    cfg = granite4_h_small.CONFIG
    params = bf16_params(torch, cfg, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out["granite"] = moe_requests(torch, cfg, params, SSD_SIZE_LENGTHS, dev,
                                  "granite4_h_small")
    del params
    free(torch, dev)
    cfg = phi35_moe.CONFIG.scaled(n_layers=16)
    params = bf16_params(torch, cfg, dev, SEED + 1)
    torch.cuda.reset_peak_memory_stats(dev)
    out["chat"] = moe_requests(torch, cfg, params, CHAT_LENGTHS, dev,
                               "phi3.5-moe x16")
    del params
    free(torch, dev)
    out["train"] = moe_train_counts(torch, dev)
    return out


def first_flash_calls(torch, fa, ref, dev):
    """One short call of each compiled kernel, checked before anything
    heavier runs: a fault of a pipeline shows here in seconds.  The tf32
    kernel first (TF32_FIRST, each on the wgmma_tf32 route); wgmma has a
    kernel per width and Q K^T step count (WGMMA_FIRST_DIMS holds one D
    of each; most leave a last TMA box mostly empty), mma one per width
    (at width - 4, which is no multiple of 8), simt one per column chunk
    in float32 (at width - 4) and one for 16-bit types (D = 300); the
    PerTensor simt kernel at each column chunk (a mix without a compute
    type at width - 4) and on each float8 format (beside float32, D = 60);
    then each wgmma and mma kernel that decodes float8, for each compute
    type (DEC_WGMMA_FIRST_DIMS, mma at width - 4, DEC_FIRST_TYPES in
    turn), each held by check_typed and on the route it should take."""
    for combo, D in TF32_FIRST:
        q, k, v = qkv(torch, 1, 2, 1, 300, 300, D,
                      tuple(getattr(torch, d) for d in combo), D, dev)
        name = fa.route(q, k, v)
        check = check_typed(torch, fa, ref, fa.flash_attention(q, k, v),
                            q, k, v)
        emit("kernel_first_call", kernel="flash_attention", dtypes=combo,
             D=D, width=fa.width(name, D), **check)
        if name != "wgmma_tf32" or not check["ok"]:
            raise AssertionError(f"{name} kernel (wgmma_tf32 wanted), "
                                 f"{combo}, D={D}: {check}")
    for combo, D in [(MIXED[1], w - 4) for w in fa.WIDTHS["simt"]] + [
            ((d, d, "float32"), 60) for d in FLOAT8]:
        q, k, v = qkv(torch, 1, 2, 1, 300, 300, D,
                      tuple(getattr(torch, d) for d in combo), D, dev)
        name = fa.route(q, k, v)
        check = check_typed(torch, fa, ref, fa.flash_attention(q, k, v),
                            q, k, v)
        emit("kernel_first_call", kernel="flash_attention", dtypes=combo,
             D=D, width=fa.width(name, D), **check)
        if not check["ok"]:
            raise AssertionError(f"{name} kernel, {combo}, D={D}: {check}")
    for dname in FLASH_TOL:
        dtype = getattr(torch, dname)
        if dname == "float32":
            dims = [w - 4 for w in fa.WIDTHS["simt"]]
        else:
            dims = WGMMA_FIRST_DIMS + [w - 4 for w in fa.WIDTHS["mma"]]
            dims += [300]
        for D in dims:
            q, k, v = qkv(torch, 1, 2, 1, 300, 300, D, dtype, D, dev)
            name = fa.route(q, k, v)
            got = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            err = float((got.float() - ref.flash_attention_ref(q, k, v)
                         .float()).abs().max())
            emit("kernel_first_call", kernel="flash_attention", dtype=dname,
                 D=D, variant=name, width=fa.width(name, D),
                 max_abs_err=err)
            if not err <= FLASH_TOL[dname]:
                raise AssertionError(f"{name} kernel, {dname}, D={D}: max "
                                     f"abs err {err}")
    for cname, combos in DEC_FIRST_TYPES.items():
        dims = [(D, "wgmma") for D in DEC_WGMMA_FIRST_DIMS]
        dims += [(w - 4, "mma") for w in fa.WIDTHS["mma"]]
        for i, (D, want) in enumerate(dims):
            combo = combos[i % len(combos)]
            q, k, v = qkv(torch, 1, 2, 1, 300, 300, D,
                          tuple(getattr(torch, d) for d in combo), D, dev)
            name = fa.route(q, k, v)
            check = check_typed(torch, fa, ref, fa.flash_attention(q, k, v),
                                q, k, v)
            emit("kernel_first_call", kernel="flash_attention", dtypes=combo,
                 D=D, width=fa.width(name, D), **check)
            if name != want or not check["ok"]:
                raise AssertionError(f"{name} kernel ({want} wanted), "
                                     f"{combo}, D={D}: {check}")


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
             "--parallel-only": flash, "--typed-times": flash,
             "--ssd-only": ["ssd", *flash],
             "--moe-only": ["moe_rows"]}.get(
                 mode, ["xor_parity", *flash, "ssd", "moe_rows"])
    if mode == "--typed-times":     # an older tree has no tf32 source
        names = [n for n in names if (_build.CSRC / f"{n}.cu").exists()]
    built = _build.build(names)
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: {"cached": v["cached"], "seconds": v["seconds"],
                        "spills": spills(v["log"]),
                        "ptxas": [ln for ln in v["log"].splitlines()
                                  if "registers" in ln or "spill" in ln
                                  or "arning" in ln or "(C7" in ln]}
                    for k, v in built.items()})

    if mode == "--typed-times":
        time_flash_types(torch, fa, ref, dev)
        return 0
    if mode == "--flash-only":
        first_flash_calls(torch, fa, ref, dev)
        check_flash_types(torch, fa, ref, dev)
        check_flash(torch, fa, ref, dev)
        time_flash_types(torch, fa, ref, dev)
        time_flash(torch, fa, ref, dev)
        return 0
    if mode == "--train-only":
        check_large_rows(torch, parity, ref, dev)
        train(torch, fa, parity, ops, dev)
        return 0
    if mode == "--entry-only":
        entry_points(torch, parity, ops, dev)
        return 0
    if mode == "--families-only":
        first_flash_calls(torch, fa, ref, dev)
        families(torch, fa, parity, ops, dev)
        return 0
    if mode == "--parallel-only":
        first_flash_calls(torch, fa, ref, dev)
        parallel(torch, fa, dev, smi)
        return 0
    if mode == "--ssd-only":
        ssd_phase(torch, dev)
        return 0
    if mode == "--moe-only":
        moe_rows_phase(torch, dev)
        return 0
    worst = check_kernel(torch, parity, ref, dev)
    ints = check_int_rows(torch, parity, ref, dev)
    large = check_large_rows(torch, parity, ref, dev)
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

    flash_err = check_flash(torch, fa, ref, dev)
    flash_types = check_flash_types(torch, fa, ref, dev)
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
    ssd_res = ssd_phase(torch, dev)
    st = ssd_res["times"][max(SSD_LENGTHS)]
    moe_res = moe_rows_phase(torch, dev)
    mt = moe_res["kernels"][f"granite_{max(SSD_SIZE_LENGTHS)}"]

    k4, fm, fz = times[4], flash_times["main"], flash_times["zamba2_d112"]
    timed_keys = ("B", "H", "Hkv", "S", "D", "variant", "ms", "strided_ms",
                  "plain_ms", "bound_ms", "bound_by", "bound_term",
                  "library_ms")
    # each variant at its timed shape: wgmma on the main path, mma at bf16
    # D=100, simt at f32 D=128
    variants = [{"name": name, "shape": shape,
                 "launches": prefill["variant_launches"].get(name, 0),
                 "max_abs_err": flash_err["by_variant"][name],
                 **{k: flash_times[shape][k] for k in timed_keys}}
                for name, shape in (("wgmma", "main"), ("mma", "d100_mma"),
                                    ("simt", "main_f32"))]

    def typed_launches(name):
        # the main path's launches of route `name` on float8 or mixed types
        return sum(n for key, n in prefill["dtype_launches"].items()
                   if key.split("/")[0] == name
                   and key.split("/")[1] not in FLASH_TOL)
    # the tensor-core routes that decode float8, each at its timed shape
    variants += [{"name": f"{name}/float8", "shape": shape,
                  "launches": typed_launches(name),
                  "max_abs_err": typed_times[shape]["check"]["max_abs_err"],
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
                  "max_abs_err": typed_times[shape]["check"]["max_abs_err"],
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
        "launches": launches, "max_abs_err": max(worst,
                                                 large["max_abs_err"]),
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": None,
        "train_launches": trained["launches"] + trained["resume"][
            "launches"],
        "train_largest_call": trained["save"]["largest_call"],
        "train_shape": {k: large[k] for k in (
            "K", "N", "ms", "plain_ms", "bound_ms", "bound_by")},
        "entry_launches": entry["launches"],
        "moe_train_launches": fams["moe"]["trainer_launches"],
        "row_types": {"types": ints["types"], "shapes": ints["shapes"],
                      "launches": sum(main_types.get(t, 0)
                                      for t in ints["types"]),
                      "checked_launches": ints["launches"],
                      "checked_type_launches": ints["type_launches"],
                      "max_abs_err": ints["max_abs_err"],
                      "timed": ints["timed"],
                      "large_timed": large["typed"]}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": prefill["launches"],
        "variant_launches": prefill["variant_launches"],
        "max_abs_err": max(flash_err["max_abs_err"].values()),
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
        "max_abs_err_by_dtype": flash_err["max_abs_err"],
        "head_dims_held": flash_err["head_dims"],
        "other_types": {
            "launches": {name: typed_launches(name) for name in fa.VARIANTS},
            "dtypes": [",".join(c) for c in
                       [(d,) * 3 for d in FLOAT8] + list(MIXED)],
            "checked_launches": flash_types["dtype_launches"],
            "sweep_launches": flash_types["sweeps"]["tensor_cores"][
                "dtype_launches"],
            "max_err": flash_types["max_err"],
            "margin_use": flash_types["margin_use"],
            "negative_windows": list(NEGATIVE_WINDOWS),
            "timed": {name: {k: t[k] for k in (
                "dtypes", "variant", "width", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_term", "design_bound_ms", "library_ms",
                "check")}
                for name, t in typed_times.items()}}}, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": None,
        "launches": ssd_res["requests"]["kernel"]["launches"],
        "chunked": ssd_res["requests"]["kernel"]["chunked"],
        "max_rel_err": max(max(t["check"]["y_rel"], t["check"]["state_rel"])
                           for t in ssd_res["times"].values()),
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "design_bound_ms": st["design_bound_ms"], "library_ms": None,
        "timed": {S: {k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "bound_share")}
                  for S, t in ssd_res["times"].items()},
        "request_ms": {"kernel": ssd_res["requests"]["kernel"]["ms"],
                       "plain": ssd_res["requests"]["plain"]["ms"]},
        "sizes": {n: {S: {k: t[k] for k in ("H", "N", "ms", "bound_ms",
                                             "bound_by", "bound_share")}
                      for S, t in times.items()}
                  for n, times in ssd_res["sizes"].items()}}, {
        "name": "moe_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_rows.cu",
        "replaces": None,
        "launches": {m: {S: r["launches"] for S, r in
                         moe_res[m]["kernel"].items()}
                     for m in ("granite", "chat")},
        "train_launches": moe_res["train"]["launches"],
        "max_ulps": max(t["check"]["y_max_ulps"]
                        for t in moe_res["kernels"].values()),
        "ms": mt["dispatch_ms"] + mt["combine_ms"],
        "plain_ms": mt["dispatch_plain_ms"] + mt["combine_plain_ms"],
        "bound_ms": mt["dispatch_bound_ms"] + mt["combine_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "timed": {n: {k: t[k] for k in (
            "dispatch_ms", "combine_ms", "dispatch_plain_ms",
            "combine_plain_ms", "dispatch_bound_ms", "combine_bound_ms")}
            for n, t in moe_res["kernels"].items()},
        "logit_gaps": {m: moe_res[m]["logits"] for m in ("granite", "chat")}}
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    modes = ("--flash-only", "--parity-only", "--train-only", "--entry-only",
             "--families-only", "--parallel-only", "--typed-times",
             "--ssd-only", "--moe-only")
    if sys.argv[1:] and (len(sys.argv) > 2 or sys.argv[1] not in modes):
        sys.exit(f"usage: chip_smoke.py [{' | '.join(modes)}]")
    try:
        code = run(sys.argv[1] if sys.argv[1:] else "")
    except Exception:                         # report, never print a result
        traceback.print_exc()
        code = 1
    sys.exit(code)
