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
     off a 16-byte boundary; then the largest call of phase 12, K=3 rows
     of 518,782,976 bytes (N = 129,695,744 lanes), checked and timed;
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
  7. the flash-attention kernel, every variant (wgmma, mma, simt), against
     its plain version on the card (2e-5 in float32, 2e-2 in bfloat16),
     over B, (H, Hkv), S, D, window, causal, Sq != Sk, FLASH_EDGES and
     strided (B,S,H,D) views;
  8. at the prefill shapes of qwen3-4b (B=2, S=4096, and one layer of
     prefill_32k: B=1, S=32768) and a gemma3-12b global layer (D=256,
     B=2, S=4096): the kernel against its plain version, element by
     element within a limit scaled to each output, then its times beside
     the operations bound, the plain version and
     scaled_dot_product_attention (a yardstick the port never calls);
  9. the main path, prefill: qwen3-4b at full width and depth (random f32
     parameters from a seed, bf16 compute) through build_prefill_step
     with attn_impl="flash" on 2 prompts of 4096 tokens; the wgmma kernel
     must launch once per layer (36 times), the logits at 10 positions must
     agree with the same step on attn_impl="ref", and two faults planted
     in the flash call (causal=False, a window of 2048) must fail that
     comparison;
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
     byte for byte, and one more step of each trainer gives bit-equal
     losses; then the same two f32 train steps (B=1, S=64) on the card
     and on the CPU agree within 1e-4.

Then the kernel summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA card is usable or the port's sources are missing.

    python3 chip_smoke.py --flash-only

is the quick check of the flash-attention kernel alone (phases 1, 2, 7, 8,
after one short call of each wgmma instantiation); it prints no result
line.  Run it under `timeout` after a change to the kernel: a fault of
its mbarrier pipeline traps after seconds, and the timeout bounds the
rest.

    python3 chip_smoke.py --parity-only

is the same for the XOR parity kernel (phases 1-4 and `write_split`); no
result line.

    python3 chip_smoke.py --train-only

runs phases 1, 2, phase 3's largest shape and phase 12; no result line.
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# operations bound: the H100 SXM float32 rate outside the tensor cores
# (no int32 XOR rate is published); memory bounds this kernel anyway
INT32_OPS_PER_S = 67e12
MAIN_MIB = 512
STRIPE = 1 << 20
SEED = 20240611


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


BF16_FLOPS_PER_S = 989e12      # H100 SXM dense tensor-core bf16
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py TOL
# at the prefill shapes (bf16), element by element: see check_flash_scaled
FLASH_REL_TOL, FLASH_ABS_TOL = 2.0 ** -7, 1e-4


def qkv(torch, B, H, Hkv, Sq, Sk, D, dtype, seed, dev, strided=False):
    """q (B,H,Sq,D), k, v (B,Hkv,Sk,D) from `seed`; `strided` gives the
    (B,H,S,D) views of (B,S,H,D) tensors, as the model passes them."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def mk(heads, S):
        if strided:
            return torch.randn(B, S, heads, D, generator=g, device=dev).to(
                dtype).transpose(1, 2)
        return torch.randn(B, heads, S, D, generator=g, device=dev).to(dtype)
    return mk(H, Sq), mk(Hkv, Sk), mk(Hkv, Sk)


# K3's edges beyond the grid of check_flash, (B, H, Hkv, Sq, Sk, D, window,
# causal): sequences that are not a multiple of the wgmma kernel's 128-row
# tiles, Sq < Sk, a window of 1024 at S=4096 and gemma3's D=256 at S=4096
FLASH_EDGES = [(1, 4, 2, 100, 100, 128, 0, True),
               (1, 32, 8, 4000, 4000, 128, 0, True),
               (2, 32, 8, 1000, 4096, 128, 0, True),
               (1, 8, 2, 128, 4000, 256, 100, True),
               (1, 32, 8, 4096, 4096, 128, 1024, True),
               (1, 16, 8, 4096, 4096, 256, 0, True),
               (1, 8, 8, 4000, 4000, 64, 1024, False)]


def check_flash(torch, fa, ref, dev) -> dict:
    """K3 check: every variant of the kernel against its plain version on
    the card, over B, (H, Hkv), S, D, window, causal and dtype, plus
    Sq != Sk (Sq < Sk, and Sq > Sk where leading rows keep no key and must
    be 0), FLASH_EDGES, and strided (B,S,H,D) views in and out.  The bf16
    FLASH_EDGES with Sk >= 1000 are also held to check_flash_scaled's
    element-wise limit."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = []
    for B in (1, 2):
        for H, Hkv in ((1, 1), (4, 2), (8, 1), (32, 8)):
            for S in (64, 128, 192, 256, 1024):
                for D in (16, 32, 64, 128, 256):
                    cases += [(B, H, Hkv, S, S, D, w, c, False)
                              for w in (0, 32, 100) for c in (True, False)]
    for Sq, Sk in ((1, 128), (64, 256), (100, 1024), (192, 1024), (128, 64)):
        for H, Hkv, D in ((4, 2, 64), (32, 8, 128), (8, 1, 256)):
            cases += [(2, H, Hkv, Sq, Sk, D, w, c, False)
                      for w in (0, 100) for c in (True, False)]
    cases += [(*e, strided) for e in FLASH_EDGES for strided in (False, True)]
    cases += [(2, 4, 2, S, S, D, 0, True, True)
              for S in (100, 192) for D in (16, 32, 64, 128, 256)]
    n, scaled = 0, []
    before = dict(fa.VARIANT_LAUNCHES)
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for i, (B, H, Hkv, Sq, Sk, D, w, c, strided) in enumerate(cases):
            q, k, v = qkv(torch, B, H, Hkv, Sq, Sk, D, dtype, i, dev, strided)
            got = fa.flash_attention(q, k, v, causal=c, window=w)
            want = ref.flash_attention_ref(q, k, v, causal=c, window=w)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if dname == "bfloat16" and Sk >= 1000 and (
                    B, H, Hkv, Sq, Sk, D, w, c) in FLASH_EDGES:
                # at long S a fixed 2e-2 is loose: hold it element by element
                check = check_flash_scaled(torch, ref, got, want, q, k, v,
                                           causal=c, window=w)
                scaled.append({"B": B, "H": H, "Hkv": Hkv, "Sq": Sq, "Sk": Sk,
                               "D": D, "window": w, "causal": c,
                               "strided": strided,
                               "worst_over_limit": check["worst_over_limit"]})
                if not check["worst_over_limit"] <= 1.0:
                    raise AssertionError(
                        f"flash_attention bf16 B={B} H={H} Hkv={Hkv} Sq={Sq} "
                        f"Sk={Sk} D={D} window={w} causal={c} strided="
                        f"{strided} differs from its plain version: {check}")
            if not err <= FLASH_TOL[dname]:
                raise AssertionError(
                    f"flash_attention {dname} B={B} H={H} Hkv={Hkv} Sq={Sq} "
                    f"Sk={Sk} D={D} window={w} causal={c} strided={strided}"
                    f" ({fa.variant(dtype, D)}): max abs err {err} > "
                    f"{FLASH_TOL[dname]}")
            if Sq > Sk and c:            # rows before the first key are 0
                if got[:, :, :Sq - Sk].abs().max() != 0:
                    raise AssertionError("a row that keeps no key is not 0")
            worst[dname] = max(worst[dname], err)
            n += 1
    ran = {k: v - before[k] for k, v in fa.VARIANT_LAUNCHES.items()}
    emit("kernel_check", kernel="flash_attention", shapes=n,
         max_abs_err=worst, tolerance=FLASH_TOL, variant_launches=ran,
         edges_over_scaled_limit=scaled)
    if not all(ran.values()):
        raise AssertionError(f"a flash variant was never checked: {ran}")
    return worst


def flash_cost(B, H, Hkv, S, D, itemsize) -> tuple[float, float, float, str]:
    """flops and bytes of causal attention at Sq == Sk == S, and the bound
    (ms) with what sets it."""
    flops = 4.0 * B * H * D * (S * (S + 1) / 2)    # QK^T and PV, kept pairs
    nbytes = itemsize * (2 * B * H * S * D + 2 * B * Hkv * S * D)
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if by_ops >= by_bytes:
        return flops, nbytes, by_ops, "operations"
    return flops, nbytes, by_bytes, "bytes"


def check_flash_scaled(torch, ref, got, want, q, k, v, causal=True,
                       window=0) -> dict:
    """The kernel's output `got` vs the plain version's `want` on q, k, v
    at a prefill shape, held element by element to
    2^-7 (|want| + |v|_P / 2) + 1e-4, where |v|_P is the plain version
    run on |v| (the P-weighted mean of |v| along the row).  2^-7 |want|
    covers the bf16 rounding of both outputs; 2^-8 |v|_P bounds the
    kernel's rounding of P to bf16 before PV (2^-9 a weight, with slack).
    At S=4096 a typical output is 0.03-0.04 and this limit about 3.5e-3,
    where a fixed 2e-2 would pass a dropped or repeated KV tile."""
    want = want.float()
    weighted = ref.flash_attention_ref(q, k, v.abs(), causal=causal,
                                       window=window).float()
    err = (got.float() - want).abs()
    mag = want.abs()
    limit = FLASH_REL_TOL * (mag + weighted / 2) + FLASH_ABS_TOL
    ratio = float((err / limit).max())
    return {"max_abs_err": float(err.max()),
            "mean_abs_want": float(mag.mean()),
            "mean_limit": float(limit.mean()),
            "max_err_over_mean_want": float(err.max() / mag.mean()),
            "worst_over_limit": ratio}


# K3's timed shapes, bf16 causal: the qwen3-4b prefill of the main path,
# one layer of qwen3-4b's prefill_32k, and a global layer of gemma3-12b
# (D=256) at the main path's B and S: (name, B, H, Hkv, S, D, reps)
FLASH_TIMED = (("main", 2, 32, 8, 4096, 128, 9),
               ("prefill_32k", 1, 32, 8, 32768, 128, 3),
               ("gemma3_d256", 2, 16, 8, 4096, 256, 9))


def time_flash(torch, fa, ref, dev) -> dict:
    """K3 at FLASH_TIMED's shapes.  At each shape the kernel's output is
    held against the plain version's on the same inputs
    (check_flash_scaled), then the kernel (on contiguous inputs, and on
    the strided (B,S,H,D) views the model passes), the plain version and
    the library call (scaled_dot_product_attention, a yardstick only) are
    timed."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, B, H, Hkv, S, D, reps in FLASH_TIMED:
        q, k, v = qkv(torch, B, H, Hkv, S, S, D, torch.bfloat16, 7, dev)
        check = check_flash_scaled(torch, ref, fa.flash_attention(q, k, v),
                                   ref.flash_attention_ref(q, k, v), q, k, v)
        emit("kernel_check", kernel="flash_attention", shape=name, B=B, S=S,
             D=D, **check)
        if not check["worst_over_limit"] <= 1.0:
            raise AssertionError(f"flash_attention at {name} (B={B}, S={S})"
                                 f" differs from its plain version: {check}")
        pool = [(q, k, v)]
        views = [tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in (q, k, v))]
        flops, nbytes, b, by = flash_cost(B, H, Hkv, S, D, 2)
        kern = time_on_card(torch, lambda t: fa.flash_attention(*t), pool,
                            reps)
        strided = time_on_card(torch, lambda t: fa.flash_attention(*t),
                               views, reps)
        plain = time_on_card(torch, lambda t: ref.flash_attention_ref(*t),
                             pool, reps)
        lib = time_on_card(torch, lambda t: sdpa(*t, is_causal=True,
                                                 enable_gqa=True), pool, reps)
        out[name] = {"B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
                     "dtype": "bfloat16", "variant": fa.variant(q.dtype, D),
                     "check": check, "flops": flops, "bytes": nbytes,
                     "ms": kern["graph_ms"], "stream_ms": kern["stream_ms"],
                     "strided_ms": strided["graph_ms"],
                     "plain_ms": plain["graph_ms"],
                     "library_ms": lib["graph_ms"], "bound_ms": b,
                     "bound_by": by, "bound_share": b / kern["graph_ms"],
                     "tflops": flops / kern["graph_ms"] / 1e9}
        del q, k, v, pool, views
        torch.cuda.empty_cache()
    emit("kernel_time", kernel="flash_attention", **out)
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


def prefill_path(torch, fa, parity, cfg, params, dev) -> dict:
    """Main path, prefill: build_prefill_step with attn_impl="flash" on B=2
    prompts of 4096 tokens, bf16 compute over f32 parameters.  Each of the
    two calls (the second one warm) must launch the flash kernel once per
    layer and the XOR kernel never.  Its logits at POSITIONS must agree
    with the same step on attn_impl="ref", and the same check must fail
    when a fault is planted in the flash call (PLANTED)."""
    from repro_torch.models import registry
    from repro_torch.models.config import RunConfig
    from repro_torch.train.steps import build_prefill_step

    tokens = prefill_tokens(torch, cfg, dev)
    rc = RunConfig(seq_len=PREFILL_S, global_batch=PREFILL_B,
                   kind="prefill", attn_impl="flash")
    step = build_prefill_step(cfg, rc, device=dev)
    hidden = (lambda out: out[0])            # forward's final hidden states
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES = parity.LAUNCHES = 0
        fa.VARIANT_LAUNCHES = dict.fromkeys(fa.VARIANTS, 0)
        with Spy(torch, fa, "flash_attention", timed=True) as flash, \
                Spy(torch, registry, "forward", keep=hidden) as fwd:
            t = time.perf_counter()
            tok, cache = step(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        runs.append({"wall_s": wall, "launches": fa.LAUNCHES,
                     "variant_launches": dict(fa.VARIANT_LAUNCHES),
                     "xor_launches": parity.LAUNCHES,
                     "flash_device_s": flash.device_s(),
                     "flash_share": flash.device_s() / wall,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        if fa.LAUNCHES != cfg.n_layers or parity.LAUNCHES or \
                fa.VARIANT_LAUNCHES["wgmma"] != cfg.n_layers:
            raise AssertionError(f"{fa.VARIANT_LAUNCHES} flash and "
                                 f"{parity.LAUNCHES} XOR launches in the "
                                 f"prefill, want {cfg.n_layers} wgmma and 0")
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
                       kind="prefill", attn_impl="ref"), device=dev)
    torch.cuda.reset_peak_memory_stats()
    with Spy(torch, registry, "forward", keep=hidden) as ref_fwd:
        t = time.perf_counter()
        ref_tok, ref_cache = ref_step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t
    ref_peak = torch.cuda.max_memory_allocated() / 2**30
    del ref_cache
    x_ref = ref_fwd.returned[0]
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
           "compute": "bfloat16", "launches": launches,
           "variant_launches": variant_launches, "runs": runs,
           "next_tokens": tok.reshape(-1).tolist(),
           "ref_next_tokens": ref_tok.reshape(-1).tolist(),
           "positions": POSITIONS, "rel_gaps": gaps,
           "tolerance_rel": PREFILL_REL_TOL, "planted_rel_gaps": planted,
           "ref_wall_s": ref_wall, "ref_peak_gib": ref_peak}
    emit("prefill", **out)
    if not max(gaps) <= PREFILL_REL_TOL:
        raise AssertionError(f"flash prefill logits differ from ref: "
                             f"{gaps} > {PREFILL_REL_TOL}")
    for name, bad in planted.items():
        if max(bad) <= PREFILL_REL_TOL:
            raise AssertionError(f"the prefill check passes the planted "
                                 f"fault {name}: {bad}")
    return out


def consistency_check(torch, cfg, params, dev) -> dict:
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
    emit("prefill_decode_consistency", **out)
    if not err <= CONSISTENCY_REL_TOL * scale:
        raise AssertionError(f"decode chain differs from the flash prefill: "
                             f"{err}")
    return out


def serve_path(torch, fa, parity, cfg, params) -> dict:
    """Main path, serving: BatchedServer on the card answers 4 requests
    with prompts of 8-64 tokens, 16 new tokens each."""
    from repro_torch.train.serve import BatchedServer

    reqs = serve_requests(cfg)
    lens = [len(r.prompt) for r in reqs]
    srv = BatchedServer(cfg, params, max_seq=256)          # device "cuda"
    fa.LAUNCHES = parity.LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = srv.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    steps = max(lens) + 16 - 1        # lockstep prompt + 15 decode steps
    res = {"requests": len(out), "prompt_lens": lens,
           "tokens_out": sum(len(r.out) for r in out), "decode_steps": steps,
           "wall_s": wall, "wall_ms_per_step": wall / steps * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "flash_launches": fa.LAUNCHES, "xor_launches": parity.LAUNCHES,
           "outs": [r.out for r in out]}
    emit("serve", **res)
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
           "bound_share": b / kern["graph_ms"]}
    emit("kernel_check_large", kernel="xor_parity", **out)
    del x, p
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


def train_path(torch, fa, parity, ops, dev, tcfg) -> dict:
    """Phase 12, the main path of training: Trainer(cluster, cfg).run(3)
    with ost1 failing before the third step, the parity-coded checkpoint
    at step 3 (one kernel launch a leaf), one stripe object of
    params.embed lost, Trainer.resume (one more launch, the stripe rebuilt
    on the card), the restored state equal to the saved one byte for byte,
    and one more step of each trainer with bit-equal losses (the loss
    depends only on the restored bytes and the batch; later steps are not
    compared, since the embedding's backward sums with atomics)."""
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
    emit("train_setup", model=tcfg.model.name, layers=tcfg.model.n_layers,
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
    emit("train_run", **out)
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
    lost_on = drop_stripe(cluster, tr.fs, f"{base}/params.embed.bin", 1)
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
    emit("train_resume", **res)
    if rebuilt != 1 or differ or tr2.step != TRAIN_STEPS or (
            cuda and resume_launches != 1) or calls.summary()["calls"] != 1:
        raise AssertionError(f"train resume: {res}")

    # each trainer takes one more step on the same batch
    losses = []
    for trainer in (tr, tr2):
        _, _, m = trainer.step_fn(trainer.params, trainer.opt_state,
                                  trainer._batch(trainer.step))
        losses.append(float(m["loss"]))
    after = {"losses": losses, "equal": losses[0] == losses[1]}
    emit("train_after_resume", **after)
    if losses[0] != losses[1]:
        raise AssertionError(f"train: losses after resume differ {losses}")
    out.update(resume=res, after_resume=after, host_peak_gib=host_peak_gib())
    return out


def train_consistency(torch, tcfg, dev) -> dict:
    """The same two train steps at phase 12's full width on the card and
    on the CPU (the named reference of this check), f32 compute, on B=1 x
    64 tokens from the seed, from one initial state made on the card:
    loss and grad_norm of each step within TRAIN_CONSISTENCY_REL
    relative."""
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
        toks = rng.integers(0, tcfg.model.vocab, (1, S), dtype=np.int32)
        lab = np.roll(toks, -1, axis=-1)
        lab[:, -1] = 0
        batches.append({"tokens": toks, "labels": lab})
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    card = layers.tree_init(registry.param_defs(tcfg.model), gen)
    host = layers.tree_map(lambda t: t.to("cpu", copy=True), card)
    runs = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        params = card if name == "card" else host
        step = build_train_step(tcfg.model, rc, device=where)
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
    card = host = None
    gaps = [max(abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm"))
            for a, b in zip(runs["card"]["steps"], runs["cpu"]["steps"])]
    out = {"S": S, "B": 1, "compute": "float32", "runs": runs,
           "rel_gaps": gaps, "tolerance_rel": TRAIN_CONSISTENCY_REL,
           "param_rel_gaps": param_gaps,
           "host_peak_gib_so_far": host_peak_gib()}
    emit("train_consistency", **out)
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


def bench_raid5(device, parity) -> dict:
    """Phase 6: the raid5 section of BENCH_rpc.json, parity on `device`.

    Client uuids are strings whose length the simulator's wire-size
    model counts, so virtual times depend on how many clients the process
    made before.  BENCH_rpc.json was written after other benchmarks had
    made clients (two-digit uuid numbers), so the sequences start there."""
    import itertools

    from repro_torch.core import dlm, llog, ptlrpc
    from repro_torch.tools.raid5_metrics import raid5_metrics

    want = json.loads((ROOT / "BENCH_rpc.json").read_text())["raid5"]
    want.pop("regressed", None)
    ptlrpc.RpcClient._uuid_seq = itertools.count(10)
    ptlrpc._trace_seq = itertools.count(1)
    dlm._handle_seq = itertools.count(1)
    llog._cookie_seq = itertools.count(1)
    launches = parity.LAUNCHES
    t0 = time.perf_counter()
    got = raid5_metrics(device=device)
    emit("bench_raid5", equal=got == want, wall_s=time.perf_counter() - t0,
         launches=parity.LAUNCHES - launches, got=got)
    if got != want:
        raise AssertionError(f"raid5 section differs: {got} != {want}")
    return got


def first_flash_calls(torch, fa, ref, dev):
    """One short call of each wgmma instantiation, checked before anything
    heavier runs: a fault of the pipeline shows here in seconds."""
    for D in (64, 128, 256):
        q, k, v = qkv(torch, 1, 2, 1, 300, 300, D, torch.bfloat16, D, dev)
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = float((got.float() - ref.flash_attention_ref(q, k, v).float())
                    .abs().max())
        emit("kernel_first_call", kernel="flash_attention", D=D,
             variant=fa.variant(q.dtype, D), max_abs_err=err)
        if not err <= FLASH_TOL["bfloat16"]:
            raise AssertionError(f"wgmma kernel at D={D}: max abs err {err}")


def train(torch, fa, parity, ops, dev) -> dict:
    """Phase 12 on the card, then its card/CPU consistency check once the
    trainers and the cluster are gone."""
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = train_config()
    out = train_path(torch, fa, parity, ops, dev, tcfg)
    gc.collect()
    torch.cuda.empty_cache()
    out["consistency"] = train_consistency(torch, tcfg, dev)
    emit("train", warm_step_s=out["warm_step_s"],
         tokens_per_s=out["tokens_per_s"], peak_gib=out["peak_gib"],
         save_s=out["save"]["wall_s"], resume_s=out["resume"]["wall_s"],
         restore_s=out["resume"]["restore_s"],
         host_peak_gib=host_peak_gib(), vtime_s=out["vtime_s"],
         launches=out["launches"] + out["resume"]["launches"])
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
    built = _build.build({"--flash-only": ["flash_attention"],
                          "--parity-only": ["xor_parity"],
                          "--train-only": ["xor_parity"]}.get(
                              mode, ["xor_parity", "flash_attention"]))
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: {"cached": v["cached"], "seconds": v["seconds"],
                        "ptxas": [ln for ln in v["log"].splitlines()
                                  if "registers" in ln or "spill" in ln
                                  or "arning" in ln or "(C7" in ln]}
                    for k, v in built.items()})

    if mode == "--flash-only":
        first_flash_calls(torch, fa, ref, dev)
        check_flash(torch, fa, ref, dev)
        time_flash(torch, fa, ref, dev)
        return 0
    if mode == "--train-only":
        check_large_rows(torch, parity, ref, dev)
        train(torch, fa, parity, ops, dev)
        return 0
    worst = check_kernel(torch, parity, ref, dev)
    large = check_large_rows(torch, parity, ref, dev)
    times = time_kernel(torch, parity, ref, ops, dev)
    if mode == "--parity-only":
        write_split(torch, ops, parity, dev)
        return 0

    parity.LAUNCHES = fa.LAUNCHES = 0
    main = main_path("cuda", MAIN_MIB, ops, parity)
    launches = parity.LAUNCHES
    if launches == 0 or launches != main["lov_calls"] or fa.LAUNCHES:
        raise AssertionError(f"{launches} kernel launches on the main path "
                             f"for {main['lov_calls']} LOV parity calls, "
                             f"{fa.LAUNCHES} flash launches")

    bench_raid5("cuda", parity)
    write_split(torch, ops, parity, dev)

    flash_err = check_flash(torch, fa, ref, dev)
    flash_times = time_flash(torch, fa, ref, dev)
    cfg, params = model_params(torch, dev)
    prefill = prefill_path(torch, fa, parity, cfg, params, dev)
    consistency_check(torch, cfg, params, dev)
    serve_path(torch, fa, parity, cfg, params)
    del params
    trained = train(torch, fa, parity, ops, dev)

    k4, fm = times[4], flash_times["main"]
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
            "K", "N", "ms", "plain_ms", "bound_ms", "bound_by")}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": prefill["launches"],
        "variant_launches": prefill["variant_launches"],
        "max_abs_err": max(flash_err.values()),
        "ms": fm["ms"], "strided_ms": fm["strided_ms"],
        "plain_ms": fm["plain_ms"],
        "bound_ms": fm["bound_ms"], "bound_by": fm["bound_by"],
        "library_ms": fm["library_ms"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    modes = ("--flash-only", "--parity-only", "--train-only")
    if sys.argv[1:] and (len(sys.argv) > 2 or sys.argv[1] not in modes):
        sys.exit(f"usage: chip_smoke.py [{' | '.join(modes)}]")
    try:
        code = run(sys.argv[1] if sys.argv[1:] else "")
    except Exception:                         # report, never print a result
        traceback.print_exc()
        code = 1
    sys.exit(code)
