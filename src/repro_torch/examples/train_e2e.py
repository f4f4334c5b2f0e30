"""End-to-end training driver over the Lustre substrate.

Trains a small transformer (default ~27M params; --large for ~110M) for a
few hundred steps with:
  * the token corpus striped across OSTs (data pipeline),
  * parity-coded striped checkpoints every N steps,
  * an OST node failure injected mid-run (transparent failover),
  * a simulated trainer death + resume from the latest checkpoint.

The port of `examples/train_e2e.py`: the same models, arguments and
printed lines, with the trainer, the model and the checkpoints' XOR
parity on `--device`.  `run()` is the script's body and returns the
printed numbers.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_e2e \
          [--steps 200] [--large] [--device cpu]
"""
from __future__ import annotations

import time

from repro_torch.core import LustreCluster
from repro_torch.examples import arg_parser
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig, RunConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def model_cfg(large: bool) -> ModelConfig:
    if large:   # ~110M params
        return ModelConfig(name="e2e-110m", family="transformer",
                           n_layers=12, d_model=768, n_heads=12,
                           n_kv_heads=4, head_dim=64, d_ff=2048,
                           vocab=8192)
    return ModelConfig(name="e2e-27m", family="transformer", n_layers=8,
                       d_model=448, n_heads=8, n_kv_heads=4, head_dim=56,
                       d_ff=1344, vocab=4096)


def parse_args(argv=None):
    ap = arg_parser(__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    return ap.parse_args(argv)


def run(args, model: ModelConfig | None = None, device="cuda", *,
        compute_dtype: str = "bfloat16", state: dict | None = None) -> dict:
    """Train `args.steps` steps with ost1 killed at a quarter of them, drop
    the trainer at half, resume from the latest checkpoint and train to
    the end.  `model` replaces the `--large` choice, `compute_dtype` is
    the train step's (the reference's: bfloat16), and `state`, a trainer
    state of numpy arrays ({"params", "opt"}), replaces the initial one."""
    cluster = LustreCluster(osts=4, mdses=1, clients=2, ost_failover=True,
                            commit_interval=64, device=device)
    cfg = TrainerConfig(
        model=model or model_cfg(args.large),
        rc=RunConfig(seq_len=args.seq, global_batch=args.batch,
                     kind="train", attn_impl="ref",
                     compute_dtype=compute_dtype),
        n_steps=args.steps, ckpt_every=max(10, args.steps // 10),
        dataset_seqs=4096, n_writers=2, parity=True)

    half = args.steps // 2
    t0 = time.time()
    tr = Trainer(cluster, cfg)
    if state is not None:
        tr.params, tr.opt_state = convert.state_from_numpy(state, tr.device)
    tr.run(half, fail_at={half // 2: lambda c: c.fail_node("ost1")})
    first = [m["loss"] for m in tr.metrics]
    ckpts = tr.ckpt.steps()

    # trainer dies; a new one resumes from the latest complete checkpoint
    del tr
    tr2 = Trainer.resume(cluster, cfg)
    resumed = tr2.step
    tr2.run(args.steps - tr2.step)
    st = cluster.stats
    return {"model": cfg.model.name, "params": cfg.model.n_params,
            "steps": args.steps, "batch": args.batch, "seq": args.seq,
            "half": half, "fail_at": half // 2, "losses_first": first,
            "checkpoints": ckpts, "resumed_at": resumed,
            "losses_after": [m["loss"] for m in tr2.metrics],
            "final_step": tr2.step, "ckpt_steps": tr2.ckpt.steps(),
            "wall_s": time.time() - t0, "vtime_s": cluster.now,
            "wrote_mib": st.bytes.get("ost.write", 0) >> 20,
            "read_mib": st.bytes.get("ost.read", 0) >> 20,
            "timeouts": st.counters.get("rpc.timeout", 0),
            "replays": st.counters.get("rpc.replay", 0)}


def main(argv=None):
    args = parse_args(argv)
    r = run(args, device=args.device)
    print(f"model: {r['model']} ({r['params']/1e6:.1f}M params), "
          f"{r['steps']} steps, batch {r['batch']} x seq {r['seq']}")
    print(f"first {r['half']} steps done (ost1 killed at {r['fail_at']}): "
          f"loss {r['losses_first'][0]:.3f} -> {r['losses_first'][-1]:.3f}")
    print("checkpoints:", r["checkpoints"])
    print(f"resumed at step {r['resumed_at']}")
    print(f"final loss {r['losses_after'][-1]:.4f} at step {r['final_step']} "
          f"({r['wall_s']:.0f}s wall, {r['vtime_s']:.1f}s "
          "virtual-storage time)")
    print("storage: wrote", r["wrote_mib"], "MiB,", "read", r["read_mib"],
          "MiB,", r["timeouts"], "timeouts,", r["replays"], "replays")
    return r


if __name__ == "__main__":
    main()
