"""The repo's examples (`examples/`) as entry points of the port, each run
as `python -m repro_torch.examples.<name> [--device cpu]`:

    quickstart     - a tour: striping, intents, failover, COBD, unlink
    failover_demo  - the six recovery mechanisms, one at a time
    serve_batched  - train, checkpoint, restore and serve in lockstep
    train_e2e      - the main path: striped corpus, parity-coded
                     checkpoints, an OST killed mid-run, a resume

Each hands `--device` to the cluster, the checkpoints and the model; it
is "cuda" by default and raises without a card (nothing falls back to
the CPU).
"""
from __future__ import annotations

import argparse


def arg_parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' `--device`."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the cluster's parity, the checkpoints and "
                         "the model run: cuda (default) or cpu")
    return ap
