"""The readings that the limits of `correct` are set from, on the card at
a cell's own size, many seeds in one process:

    python3 -m chipbench.calibrate --workload <name> --seeds a,b,... \
        [--control-seeds c,d,...] [--seconds s] [--rounds r] [--late-only]

For each seed it prints one JSON line with the program's numbers (the
lower readings); for each control seed, the control's (the upper
readings), and for a training cell the half-batch fault's too.  A prefill
cell's program numbers come from the timed path's step on the requests
that a run which finished `rounds` rounds checks (`Job.sample`), with
the readings they are taken from under `detail`; its control is the
reference in float8 in the program's place (`Job.control`).  A training
cell's come from the set-up's first steps and from the late step after a
window of `seconds` (`--late-only`: that step's alone, and no fault), its
control is the reference's steps in float8, and its fault a step that
leaves half of the batch out.  The checkpoint cell runs
a short window of the program, and as its control the same window with
the program's own int8 storage path switched on.  Not run by the
benchmark's own runs.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def _free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(cell, seed: int, control: bool, device, seconds: float,
             rounds: int = 12, late_only: bool = False):
    from chipbench.cell import execute
    if cell.kind == "prefill":
        from chipbench.kinds.prefill import Job
        job = Job(cell, seed, device)
        job.setup(warm=False)
        idx = job.sample(rounds * job.prompts.per_round)
        out = {"program": job.program(idx, detail=True)}
        if control:
            out["control"] = job.control(idx, detail=True)
        out["detail"] = {k: v.pop("detail") for k, v in list(out.items())}
        return out
    if cell.kind == "train":
        from chipbench import ref
        from chipbench.kinds.train import HalfBatch, Job
        job = Job(cell, seed, device)
        job.setup()
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline:
            job.unit(job.tr.step)
        job.release()
        _free()
        late = job.late_reference(ref.F32)
        _free()
        out = {"late_step": job.late["step"],
               "program": job.late_numbers(job.late, late)}
        if control:
            out["control"] = job.late_numbers(job.late_reference(ref.FP8),
                                              late)
        if late_only:
            return out
        want = job.reference(ref.F32)
        _free()
        out["program"].update(job.numbers(job.program(), want))
        if control:
            out["control"].update(job.numbers(job.reference(ref.FP8), want))
            del job
            _free()
            job = HalfBatch(cell, seed, device)
            job.setup()
            job.release()
            out["half_batch"] = job.numbers(job.program(), want)
            out["half_batch"].update(job.late_numbers(
                job.late, job.late_reference(ref.F32)))
        return out
    from chipbench.kinds.ckpt import Job
    out = {"program": execute(cell, seed, seconds, False, device,
                              time.perf_counter())["checks"]}
    if control:
        out["control"] = execute(
            cell, seed, seconds, False, device, time.perf_counter(),
            job=Job(cell, seed, device, quantize="int8"))["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--late-only", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from chipbench.cell import load_cell
    if not torch.cuda.is_available():
        print("chipbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        out = readings(cell, seed, seed in args.control_seeds, "cuda",
                       args.seconds, args.rounds, args.late_only)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
