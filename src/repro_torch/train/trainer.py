"""Fault-tolerant trainer: the training loop of `repro.train.trainer` over
the Lustre substrate, in PyTorch on the cluster's device.

  * data: the deterministic TokenPipeline reading a striped corpus;
  * checkpoints: CheckpointManager (striped, parity-coded on the card,
    crash-consistent manifests), saved every `ckpt_every` steps and at
    the end of a run; `Trainer.resume()` restores the latest complete
    checkpoint and continues at the exact step;
  * fault tolerance: OST/MDS failures during the run recover inside the
    storage clients (failover ring / replay); a trainer death is
    recovered by a fresh Trainer and `resume()`.

  * elasticity: with a mesh (a DeviceMesh over the ranks of the process
    group, every rank running its own Trainer on the same cluster
    state), parameters and optimizer state are DTensors placed by
    `steps.param_specs`; `resume()` restores whole tensors and places
    them on whatever mesh the new trainer has.  Without a mesh the state
    lives whole on the cluster's device.

Every family of the registry trains; a model with an encoder or a patch
prefix gets each step's stub frames or patches from `side_inputs`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core.cluster import LustreCluster
from repro_torch.data import TokenDataset, TokenPipeline
from repro_torch.fsio import LustreClient
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, RunConfig
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_mod


@dataclasses.dataclass
class TrainerConfig:
    model: ModelConfig
    rc: RunConfig
    n_steps: int = 50
    ckpt_every: int = 10
    ckpt_base: str = "/ckpt"
    data_path: str = "/data/tokens.bin"
    n_writers: int = 2
    parity: bool = True
    dataset_seqs: int = 2048
    seed: int = 0


class Trainer:
    def __init__(self, cluster: LustreCluster, cfg: TrainerConfig,
                 mesh=None):
        """The trainer runs on the cluster's device (the card, by
        default), sharded over `mesh` when one is given."""
        self.cluster = cluster
        self.cfg = cfg
        self.device = cluster.device
        self.mesh = mesh
        self.step_fn = steps_mod.build_train_step(
            cfg.model, cfg.rc, device=self.device, mesh=mesh)
        # storage clients: writer 0 is also the data-plane reader
        n_clients = len(cluster.client_nodes)
        self.writers = [LustreClient(cluster, i % n_clients).mount()
                        for i in range(cfg.n_writers)]
        self.fs = self.writers[0]
        self.ckpt = CheckpointManager(
            self.writers, cfg.ckpt_base, parity=cfg.parity,
            stripe_count=min(3, len(cluster.ost_targets)),
            stripe_size=1 << 18)
        self.dataset = TokenDataset(
            self.fs, cfg.data_path, vocab=cfg.model.vocab,
            seq_len=cfg.rc.seq_len, n_seqs=cfg.dataset_seqs,
            seed=cfg.seed).build()
        gb = cfg.rc.global_batch
        self.pipeline = TokenPipeline(self.fs, self.dataset, dp_rank=0,
                                      dp_size=1, batch_per_rank=gb,
                                      seed=cfg.seed)
        self.step = 0
        self.params = None
        self.opt_state = None
        self.metrics: list[dict] = []

    # ---------------------------------------------------------------- init
    def init_state(self):
        gen = torch.Generator(self.device).manual_seed(self.cfg.seed)
        self.params = self._place(L.tree_init(
            registry.param_defs(self.cfg.model), gen,
            getattr(torch, self.cfg.rc.param_dtype)))
        self.opt_state = adamw.init_state(self.params)
        return self

    def _place(self, params):
        """Whole parameters (or moments) on the trainer's mesh, placed by
        `steps.param_specs`; unchanged without a mesh."""
        if self.mesh is None:
            return params
        return L.tree_distribute(params, self.mesh, steps_mod.param_specs(
            self.cfg.model, self.cfg.rc, self.mesh))

    # ---------------------------------------------------------------- data
    def _batch(self, step: int) -> dict:
        toks = self.pipeline.batch_at(step)
        # next-token labels within the stored sequence
        lab = np.roll(toks, -1, axis=-1)
        lab[:, -1] = 0
        b = {"tokens": toks, "labels": lab}
        nmb = self.cfg.rc.num_microbatches
        if nmb > 1:
            b = {k: v.reshape(nmb, v.shape[0] // nmb, *v.shape[1:])
                 for k, v in b.items()}
        b = {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}
        return {**b, **self.side_inputs(step)}

    def side_inputs(self, step: int) -> dict:
        """Step `step`'s stub encoder frames or patch embeddings, at the
        batch's shapes (`steps.batch_shapes`), standard normal in bf16
        from a generator seeded with the step.  (The reference draws them
        with jax.random.normal(PRNGKey(step)), whose numbers PyTorch
        cannot reproduce: a cross test hands the reference's arrays in
        through this method.)"""
        gen = torch.Generator(self.device).manual_seed(step)
        shapes = steps_mod.batch_shapes(self.cfg.model, self.cfg.rc,
                                        with_labels=False)
        return {name: torch.randn(shape, generator=gen, device=self.device,
                                  dtype=torch.float32).to(dtype)
                for name, (shape, dtype) in shapes.items()
                if name in ("frames", "patches")}

    # ---------------------------------------------------------------- loop
    def run(self, n_steps: int | None = None, *, fail_at: dict | None = None
            ) -> list[dict]:
        """Train. `fail_at` maps step -> callable(cluster) fault injection
        (e.g. lambda c: c.fail_node('ost1'))."""
        n = n_steps if n_steps is not None else self.cfg.n_steps
        if self.params is None:
            self.init_state()
        end = self.step + n
        while self.step < end:
            if fail_at and self.step in fail_at:
                fail_at[self.step](self.cluster)
            batch = self._batch(self.step)
            self.params, self.opt_state, m = self.step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            rec = {"step": self.step, "loss": float(m["loss"]),
                   "grad_norm": float(m["grad_norm"])}
            self.metrics.append(rec)
            if self.step % self.cfg.ckpt_every == 0 or self.step == end:
                self.save_checkpoint()
        return self.metrics

    # ---------------------------------------------------------- checkpoint
    def _state_tree(self) -> dict:
        """The state as the checkpoint stores it: tensors, which the
        manager brings to the host once."""
        return {"params": self.params,
                "opt": {"step": self.opt_state["step"],
                        "m": self.opt_state["m"],
                        "v": self.opt_state["v"]}}

    def save_checkpoint(self):
        self.ckpt.save(self.step, self._state_tree(),
                       extra_meta={"arch": self.cfg.model.name})

    @classmethod
    def resume(cls, cluster: LustreCluster, cfg: TrainerConfig,
               mesh=None) -> "Trainer":
        """Fresh trainer (possibly on another mesh, or none: elastic)
        restored from the latest complete checkpoint.  Shapes come from
        the manifest; each leaf is rebuilt on the trainer's device,
        parameters in the run's param dtype, then placed on the mesh."""
        t = cls(cluster, cfg, mesh)
        t.ckpt.cleanup_incomplete()
        flat, manifest = t.ckpt.restore()
        t.step = manifest["step"]
        pdt = getattr(torch, cfg.rc.param_dtype)
        state: dict = {}
        for name in sorted(flat):
            path = name.split(".")
            leaf = flat.pop(name)             # the host copy goes at once
            dtype = pdt if path[0] == "params" else None
            if not isinstance(leaf, torch.Tensor):      # bf16 comes as one
                leaf = torch.from_numpy(np.array(leaf))  # writable copy
            L.tree_set(state, path, leaf.to(t.device, dtype))
        t.params = t._place(state["params"])
        opt = state["opt"]
        t.opt_state = {"step": opt["step"], "m": t._place(opt["m"]),
                       "v": t._place(opt["v"])}
        return t
