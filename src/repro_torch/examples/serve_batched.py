"""Batched serving from a Lustre checkpoint.

Trains a tiny model for a handful of steps, checkpoints it to the striped
store, then a *separate* serving process restores the weights (read path,
collaborative-cache eligible) and decodes a batch of prompts in lockstep.
The port of `examples/serve_batched.py`: the same model, cluster,
requests and printed lines; the trainer and the server run on `--device`.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import LustreCluster
from repro_torch.examples import arg_parser
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig, RunConfig
from repro_torch.train.serve import BatchedServer, Request
from repro_torch.train.trainer import Trainer, TrainerConfig

MODEL = ModelConfig(name="serve-demo", family="transformer", n_layers=2,
                    d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                    d_ff=256, vocab=512)


def trainer_config(compute_dtype: str = "bfloat16") -> TrainerConfig:
    return TrainerConfig(
        model=MODEL,
        rc=RunConfig(seq_len=64, global_batch=4, kind="train",
                     attn_impl="ref", compute_dtype=compute_dtype),
        n_steps=10, ckpt_every=10, dataset_seqs=256, n_writers=2,
        parity=False)


def requests() -> list[Request]:
    rng = np.random.default_rng(0)
    return [Request(i, list(rng.integers(1, 500, size=rng.integers(3, 9))),
                    max_new=8) for i in range(4)]


def run(device="cuda", *, compute_dtype: str = "bfloat16",
        state: dict | None = None) -> dict:
    """Train 10 steps, checkpoint, restore through `Trainer.resume` and
    serve 4 requests, all on `device`.  `compute_dtype` is that of the
    train steps and of the server (the reference's: bfloat16); `state`, a
    trainer state of numpy arrays ({"params", "opt"}), replaces the
    trainer's initial one."""
    cluster = LustreCluster(osts=4, mdses=1, clients=2, commit_interval=64,
                            device=device)
    cfg = trainer_config(compute_dtype)
    tr = Trainer(cluster, cfg)
    if state is not None:
        tr.params, tr.opt_state = convert.state_from_numpy(state, tr.device)
    tr.run()
    # ---- serving side: restore weights from the striped store
    tr2 = Trainer.resume(cluster, cfg)       # separate reader
    srv = BatchedServer(MODEL, tr2.params, max_seq=64, device=device)
    srv.rc = dataclasses.replace(srv.rc, compute_dtype=compute_dtype)
    out = srv.generate(requests())
    return {"ckpt_steps": tr.ckpt.steps(),
            "losses": [m["loss"] for m in tr.metrics],
            "outs": [{"rid": r.rid, "prompt_len": len(r.prompt),
                      "out": r.out} for r in out],
            "weights_kib": cluster.stats.bytes.get("ost.read", 0) >> 10}


def main(argv=None):
    res = run(arg_parser(__doc__).parse_args(argv).device)
    print("trained 10 steps, checkpointed at", res["ckpt_steps"])
    for r in res["outs"]:
        print(f"req {r['rid']}: prompt[{r['prompt_len']}] -> {r['out']}")
    print(f"weights read from the striped store: {res['weights_kib']} KiB")
    return res


if __name__ == "__main__":
    main()
