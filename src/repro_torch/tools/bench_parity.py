"""XOR parity kernel against its memory bound, and raid5 end to end.

The port of `benchmarks/bench_parity.py`'s `run()`:

  * the kernel half: for K in {2, 4, 8, 16} stripes of N = 1<<20 int32
    lanes (numpy `default_rng(0)`), the port's `parity.xor_parity` on
    `--device`, checked bit-exact against its plain version
    (`kernels/ref.py`); the bytes it moves, its arithmetic intensity and
    its bound at the H100's memory rate (`kernels/hardware.py`); on the
    card also the kernel's time, the median of CUDA-event timings of
    graph replays over inputs that exceed the L2 cache (no time on the
    CPU);
  * the raid5 half: `tools/raid5_metrics.py`, with parity on `--device`.

    PYTHONPATH=src python -m repro_torch.tools.bench_parity [--device cpu]

Writes results/bench/torch_parity.json.
"""
from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from repro_torch.kernels import parity, ref
from repro_torch.kernels.hardware import HBM_BYTES_PER_S
from repro_torch.kernels.ops import resolve_device
from repro_torch.tools.bench_common import save, table
from repro_torch.tools.raid5_metrics import raid5_metrics

N = 1 << 20
STRIPES = (2, 4, 8, 16)
L2_BYTES = 50 << 20            # the H100's L2; timed inputs exceed twice it


def kernel_ms(blocks: torch.Tensor, reps: int = 15) -> float:
    """Median ms of one `xor_parity` call on the card: calls over copies
    of `blocks` (together past twice the L2, so each reads device
    memory) captured in a CUDA graph, replayed `reps` times between CUDA
    events."""
    pool = [blocks.clone()
            for _ in range(-(-2 * L2_BYTES // (blocks.numel() * 4)))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm up, as capture asks
        for x in pool:
            parity.xor_parity(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in pool:
            parity.xor_parity(x)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(pool))
    return statistics.median(times)


def kernel_half(device="cuda", n: int = N) -> dict:
    """Per K: the kernel checked against its plain version, its bytes,
    intensity and bound; on the card its time."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out = {}
    for k in STRIPES:
        blocks = torch.from_numpy(rng.integers(-2**31, 2**31, size=(k, n),
                                               dtype=np.int32)).to(dev)
        if not torch.equal(parity.xor_parity(blocks),
                           ref.xor_parity_ref(blocks)):
            raise AssertionError(f"xor_parity K={k} N={n} differs from "
                                 "its plain version")
        bytes_moved = (k + 1) * n * 4
        bound_s = bytes_moved / HBM_BYTES_PER_S
        row = {"stripes": k, "lanes": n, "bit_exact": True,
               "bytes_moved": bytes_moved, "bound_s": bound_s,
               "bound_GBps": round(k * n * 4 / bound_s / 1e9, 1),
               "arith_intensity_ops_per_byte": round((k - 1)
                                                     / ((k + 1) * 4), 4),
               "bound": "memory"}
        if dev.type == "cuda":
            ms = kernel_ms(blocks)
            row.update(kernel_s=ms / 1e3, bound_share=bound_s / (ms / 1e3),
                       effective_GBps=round(k * n * 4 / ms / 1e6, 1))
        out[k] = row
    return out


def run(device="cuda") -> dict:
    out = kernel_half(device)
    timed = "kernel_s" in out[STRIPES[0]]
    table("XOR parity kernel: H100 memory bound" + (
        " and time on the card" if timed else "") + " (verified vs plain)",
          ["K stripes", "HBM traffic", "bound t", "bound GB/s", "ops/byte"]
          + (["kernel t", "share"] if timed else []),
          [[k, f"{r['bytes_moved'] >> 20} MiB",
            f"{r['bound_s'] * 1e6:.1f} us", f"{r['bound_GBps']:.0f}",
            f"{r['arith_intensity_ops_per_byte']:.3f}"]
           + ([f"{r['kernel_s'] * 1e6:.1f} us", f"{r['bound_share']:.2f}"]
              if timed else []) for k, r in out.items()])
    r5 = raid5_metrics(device)
    out["raid5"] = r5
    table("raid5 end-to-end", ["metric", "value"],
          [["degraded read identical", r5["degraded"]["identical"]],
           ["degraded overhead", f"{r5['degraded']['overhead_x']}x"],
           ["rebuild MB/s (virtual)", r5["rebuild"]["throughput_MBps"]],
           ["app p99 ratio (tbf)", r5["throttle"]["tbf_p99_ratio"]],
           ["app p99 ratio (fifo)", r5["throttle"]["fifo_p99_ratio"]]])
    save("torch_parity", out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
