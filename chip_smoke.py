#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the last line:

  1. the card's name and power limit (nvidia-smi);
  2. the build of every kernel from `src/repro_torch/csrc` (nvcc, sm_90a);
  3. the XOR parity kernel against its plain PyTorch version on the card,
     bit-exact, over K in {1..16} rows and N from 1 to 4194304 lanes,
     with every missing row reconstructed;
  4. kernel times at the shapes of the main path (CUDA events, median;
     replayed from a CUDA graph for the card's own time, and issued from
     Python), beside the memory bound and the plain version;
  5. the main path: a raid5 file of 512 MiB at 1 MiB stripes, 4 data +
     1 parity, written, read clean, read degraded with ost1 dead,
     rebuilt onto a spare through lctl and truncated, all through
     `LustreCluster(device="cuda")` and `LustreClient`, every read
     byte-identical; the kernel's launches are counted over this phase
     only and must equal the LOV's parity and reconstruction calls;
  6. the raid5 section of BENCH_rpc.json reproduced with parity on the
     card.

Then the kernel summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA card is usable or the port's sources are missing.
"""
from __future__ import annotations

import json
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
    absolute difference seen (0)."""
    worst, shapes = 0, 0
    for k in (1, 2, 3, 4, 5, 8, 16):
        for n in (1, 37, 1000, 4097, 262144, 262145, 4194304):
            x = rows(torch, k, n, k * 1000003 + n, dev)
            p = parity.xor_parity(x)
            want = ref.xor_parity_ref(x)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_err(torch, p, want))
            if not torch.equal(p, want):
                raise AssertionError(f"xor_parity K={k} N={n} differs")
            for miss in range(k):
                surv = torch.cat([x[:miss], x[miss + 1:]], 0)
                rec = parity.reconstruct(surv, p)
                if not torch.equal(rec, x[miss]):
                    raise AssertionError(
                        f"reconstruct K={k} N={n} row {miss} differs")
            shapes += 1
    # rows that do not start on a 16-byte boundary: the 4-byte path
    for k, n in ((3, 37), (4, 262144), (5, 262145)):
        x = rows(torch, k, n, 7 * n + k, dev)
        buf = torch.empty(k * n + 1, dtype=torch.int32, device=dev)
        buf[1:].copy_(x.reshape(-1))
        shifted = buf[1:].view(k, n)
        if not torch.equal(parity.xor_parity(shifted), ref.xor_parity_ref(x)):
            raise AssertionError(f"misaligned K={k} N={n} differs")
        shapes += 1
    torch.cuda.synchronize()
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
    """Phase 4: kernel, plain version and the chain of K-1
    torch.bitwise_xor calls at the main path's shapes."""
    def chain(x):
        acc = torch.bitwise_xor(x[0], x[1]) if x.shape[0] > 1 else x[0]
        for i in range(2, x.shape[0]):
            acc = torch.bitwise_xor(acc, x[i])
        return acc

    out = {}
    n = STRIPE // 4
    for k in (4, 5):
        count = -(-(96 << 20) // (k * n * 4))     # > 96 MiB of inputs
        pool = [rows(torch, k, n, 31 * i + k, dev) for i in range(count)]
        b, by = bound_ms(k, n)
        kern = time_on_card(torch, parity.xor_parity, pool)
        plain = time_on_card(torch, ref.xor_parity_ref, pool)
        chained = time_on_card(torch, chain, pool)
        out[k] = {"K": k, "N": n,
                  "ms": kern["graph_ms"], "plain_ms": plain["graph_ms"],
                  "chain_bitwise_xor_ms": chained["graph_ms"],
                  "stream_ms": kern["stream_ms"],
                  "plain_stream_ms": plain["stream_ms"],
                  "bound_ms": b, "bound_by": by,
                  "bound_share": b / kern["graph_ms"]}
        del pool
    # one whole parity call of the LOV: 4 units of 1 MiB from host bytes
    # to parity bytes (marshal, copy in, kernel, copy out)
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
    emit("kernel_time", **{str(k): v for k, v in out.items()})
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


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops, parity, ref

    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit("card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    built = _build.build(["xor_parity"])
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: {"cached": v["cached"], "seconds": v["seconds"],
                        "ptxas": [ln for ln in v["log"].splitlines()
                                  if "registers" in ln or "spill" in ln]}
                    for k, v in built.items()})

    worst = check_kernel(torch, parity, ref, dev)
    times = time_kernel(torch, parity, ref, ops, dev)

    parity.LAUNCHES = 0
    main = main_path("cuda", MAIN_MIB, ops, parity)
    launches = parity.LAUNCHES
    if launches == 0 or launches != main["lov_calls"]:
        raise AssertionError(f"{launches} kernel launches on the main path "
                             f"for {main['lov_calls']} LOV parity calls")

    bench_raid5("cuda", parity)

    k4 = times[4]
    print(json.dumps({"kernels": [{
        "name": "xor_parity", "route": "cuda",
        "source": "src/repro_torch/csrc/xor_parity.cu",
        "replaces": "src/repro/kernels/parity.py:23",
        "launches": launches, "max_abs_err": worst,
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = run()
    except Exception:                         # report, never print a result
        traceback.print_exc()
        code = 1
    sys.exit(code)
