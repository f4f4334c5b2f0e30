"""The port's multi-device path on 4 gloo ranks of CPU processes.

One run of 4 ranks per module (`gloo_run`, bounded by RUN_TIMEOUT) does
the work on a (2, 2) ("data", "model") mesh and writes what it saw; the
tests hold it against single-device runs and the reference:

* the sharded train step (qwen3-4b smoke config, fsdp on, f32 compute)
  against the port's single-device step on the same parameters and
  batches: loss and grad norm of 2 steps within 1e-5 relative, every
  parameter after them within 1e-5 (sums over devices run in another
  order; about 1e-7 was seen);
* `moe_ffn_sharded` (phi3.5-moe smoke config, f32) against the
  reference's `moe_ffn_sharded`, run in a subprocess on 4 forced host
  devices of a (2, 2) mesh of Auto axes (ROADMAP R1): y and aux within
  1e-5, the dropped assignments equal to a count from the reference's
  routing;
* elastic resume: a Trainer trains 4 steps on (2, 2), a fresh one resumes
  on (4, 1): parameters and moments bit-equal to those saved, then 2
  more finite steps; and the checkpoint the sharded trainer wrote is
  byte-identical, manifest included, to a single-device save of the same
  state.

Run alone: `PYTHONPATH=src python -m pytest -q tests/test_torch_parallel.py`.
The worker is this file run as a script: `python
tests/test_torch_parallel.py RANK DIR`.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
RUN_TIMEOUT = 300          # seconds for the whole 4-rank run
TRAIN_REL = 1e-5
MOE_TOL = 1e-5
MOE_T = 64                 # tokens: 32 a data shard
SEED = 7


def _train_rc():
    from repro_torch.models.config import RunConfig
    return RunConfig(seq_len=32, global_batch=4, kind="train",
                     attn_impl="ref", compute_dtype="float32", fsdp="on")


def _moe_rc(RunConfig):
    return RunConfig(seq_len=32, global_batch=2, kind="train",
                     compute_dtype="float32", shard_moe_tokens=True)


def _batches(cfg, n=2):
    rng = np.random.default_rng(SEED)
    return [{k: rng.integers(0, cfg.vocab, (4, 32), dtype=np.int32)
             for k in ("tokens", "labels")} for _ in range(n)]


def _moe_inputs(cfg):
    """Layer 0's router and experts of the phi3.5-moe smoke config and
    MOE_T tokens, standard normal over sqrt(fan-in), float32."""
    rng = np.random.default_rng(SEED)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {"x": rng.standard_normal((MOE_T, d), np.float32),
            "router": rng.standard_normal((d, E), np.float32) / d ** 0.5,
            "wg": rng.standard_normal((E, d, f), np.float32) / d ** 0.5,
            "wu": rng.standard_normal((E, d, f), np.float32) / d ** 0.5,
            "wd": rng.standard_normal((E, f, d), np.float32) / f ** 0.5}


def _elastic_cfg():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import RunConfig
    from repro_torch.train.trainer import TrainerConfig
    return TrainerConfig(
        model=get_smoke_config("qwen3-4b"),
        rc=RunConfig(seq_len=32, global_batch=8, kind="train",
                     attn_impl="ref"),
        n_steps=4, ckpt_every=2, dataset_seqs=64, n_writers=1, parity=False)


def _cluster():
    from repro_torch.core import LustreCluster
    return LustreCluster(osts=2, mdses=1, clients=2, commit_interval=64,
                         device="cpu")


def _ckpt_files(cluster, step, base="/ckpt"):
    """{file name: bytes} of one checkpoint step as stored."""
    from repro_torch.fsio import LustreClient
    fs = LustreClient(cluster).mount()
    d = f"{base}/step_{step:08d}"
    out = {}
    for name in sorted(fs.readdir(d)):
        fh = fs.open(f"{d}/{name}")
        out[name] = fs.read(fh, 1 << 30)
        fs.close(fh)
    return out


# ------------------------------------------------------------------ worker

def worker(rank: int, out: pathlib.Path):
    """One gloo rank: every multi-device case, its results written by
    rank 0."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe, registry
    from repro_torch.models.config import RunConfig
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from repro_torch.train.trainer import Trainer

    torch.set_num_threads(1)          # WORLD ranks share the cores
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=WORLD)
    mesh = make_host_mesh(model=2, device_type="cpu")          # (2, 2)
    res = {}

    # sharded train step
    cfg, rc = get_smoke_config("qwen3-4b"), _train_rc()
    params = L.tree_init(registry.param_defs(cfg),
                         torch.Generator("cpu").manual_seed(SEED))
    params = L.tree_distribute(params, mesh, steps.param_specs(cfg, rc, mesh))
    opt = adamw.init_state(params)
    step = steps.build_train_step(cfg, rc, device="cpu", mesh=mesh)
    res["train"] = []
    for b in _batches(cfg):
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        res["train"].append([float(m["loss"]), float(m["grad_norm"])])
    full = {".".join(k): v.numpy() for k, v in
            L.tree_items(L.tree_full(params))}
    if rank == 0:
        np.savez(out / "train_params.npz", **full)

    # sharded MoE dispatch
    mcfg = get_smoke_config("phi3.5-moe")
    z = {k: torch.from_numpy(v) for k, v in _moe_inputs(mcfg).items()}
    stats = {}
    y, aux = moe.moe_ffn_sharded(mcfg, z, z["x"], _moe_rc(RunConfig), mesh,
                                 stats)
    res["moe"] = {"aux": float(aux.full_tensor()),
                  "dropped": stats["dropped"]}
    y = y.full_tensor().numpy()
    if rank == 0:
        np.save(out / "moe_y.npy", y)

    # elastic resume (2, 2) -> (4, 1)
    cluster, tcfg = _cluster(), _elastic_cfg()
    tr = Trainer(cluster, tcfg, mesh=mesh)
    tr.run(4)
    state = {".".join(k): v.numpy() for k, v in
             L.tree_items(L.tree_full(tr._state_tree()))}
    mesh41 = make_host_mesh(model=1, device_type="cpu")        # (4, 1)
    assert tuple(mesh41.shape) == (4, 1)
    tr2 = Trainer.resume(cluster, tcfg, mesh=mesh41)
    got = {".".join(k): v.numpy() for k, v in
           L.tree_items(L.tree_full(tr2._state_tree()))}
    res["elastic"] = {
        "step": tr2.step,
        "placements": str(tr2.params["layers"]["mlp"]["wg"].placements),
        "equal": sorted(got) == sorted(state) and all(
            np.array_equal(got[k], state[k]) for k in state),
        "losses": [r["loss"] for r in tr2.run(2)]}
    if rank == 0:
        np.savez(out / "elastic_state.npz", **state)
        files = _ckpt_files(cluster, 4)
        np.savez(out / "elastic_files.npz",
                 **{k: np.frombuffer(v, np.uint8) for k, v in files.items()})
        (out / "results.json").write_text(json.dumps(res))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    deadline = time.monotonic() + RUN_TIMEOUT
    logs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD}-rank gloo run took over {RUN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + logs[bad[0][0]][-4000:]
    return out, json.loads((out / "results.json").read_text())


# ------------------------------------------------------------------- tests

def test_sharded_train_step_matches_single_device(gloo_run):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    out, res = gloo_run
    cfg, rc = get_smoke_config("qwen3-4b"), _train_rc()
    params = L.tree_init(registry.param_defs(cfg),
                         torch.Generator("cpu").manual_seed(SEED))
    opt = adamw.init_state(params)
    step = steps.build_train_step(cfg, rc, device="cpu")
    for b, (loss, gnorm) in zip(_batches(cfg), res["train"]):
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        assert abs(loss - float(m["loss"])) <= TRAIN_REL * abs(loss)
        assert abs(gnorm - float(m["grad_norm"])) <= TRAIN_REL * gnorm
    got = np.load(out / "train_params.npz")
    for k, v in L.tree_items(params):
        want = v.numpy()
        gap = float(np.abs(got[".".join(k)] - want).max())
        assert gap <= TRAIN_REL * max(1.0, float(np.abs(want).max())), k


def _ref_moe(tmp, cfg):
    """The reference's moe_ffn_sharded on a (2, 2) mesh of Auto axes over
    4 forced host devices, in a subprocess (the device count is fixed
    when JAX starts); returns (y, aux, top_e)."""
    np.savez(tmp / "moe_in.npz", **_moe_inputs(cfg))
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import AxisType
        from repro.configs import get_smoke_config
        from repro.models import moe
        from repro.models.config import RunConfig
        cfg = get_smoke_config("phi3.5-moe")
        rc = RunConfig(seq_len=32, global_batch=2, kind="train",
                       compute_dtype="float32", shard_moe_tokens=True)
        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        z = dict(np.load("{tmp}/moe_in.npz"))
        p = {{k: jnp.asarray(z[k]) for k in ("router", "wg", "wu", "wd")}}
        y, aux = moe.moe_ffn_sharded(cfg, p, jnp.asarray(z["x"]), rc, mesh)
        probs = jax.nn.softmax(jnp.asarray(z["x"]) @ p["router"], axis=-1)
        _, top_e = jax.lax.top_k(probs, cfg.top_k)
        np.savez("{tmp}/moe_ref.npz", y=np.asarray(y), aux=np.asarray(aux),
                 top_e=np.asarray(top_e))
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    done = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=RUN_TIMEOUT)
    assert done.returncode == 0, done.stderr[-3000:]
    r = np.load(tmp / "moe_ref.npz")
    return r["y"], float(r["aux"]), r["top_e"]


def _dropped(top_e, n_experts, C, dp=2):
    """Assignments past their expert's capacity C, each data shard's
    tokens routed alone: an expert keeps the first C of its assignments
    in (token, slot) order."""
    n = 0
    for shard in np.split(top_e, dp):
        counts = np.bincount(shard.reshape(-1), minlength=n_experts)
        n += int(np.maximum(counts - C, 0).sum())
    return n


def test_sharded_moe_matches_reference(gloo_run, tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    out, res = gloo_run
    cfg = get_smoke_config("phi3.5-moe")
    y_ref, aux_ref, top_e = _ref_moe(tmp_path, cfg)
    y = np.load(out / "moe_y.npy")
    assert y.shape == y_ref.shape
    assert float(np.abs(y - y_ref).max()) <= MOE_TOL
    assert abs(res["moe"]["aux"] - aux_ref) <= MOE_TOL
    C = moe.capacity(cfg, MOE_T // 2)
    assert res["moe"]["dropped"] == _dropped(top_e, cfg.n_experts, C)


def test_elastic_resume_restores_bit_equal_and_trains(gloo_run):
    _, res = gloo_run
    e = res["elastic"]
    assert e["step"] == 4 and e["equal"], e
    assert e["placements"] == "(Shard(dim=1), Shard(dim=2))", e
    assert len(e["losses"]) == 2 and all(np.isfinite(e["losses"]))


def test_sharded_checkpoint_bytes_equal_single_device_save(gloo_run):
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.fsio import LustreClient
    from repro_torch.models import layers as L

    out, _ = gloo_run
    state = np.load(out / "elastic_state.npz")
    tree: dict = {}
    for name in state.files:
        L.tree_set(tree, name.split("."), torch.from_numpy(state[name]))
    cluster = _cluster()
    fs = LustreClient(cluster).mount()
    CheckpointManager([fs], "/ckpt", parity=False,
                      stripe_count=min(3, len(cluster.ost_targets)),
                      stripe_size=1 << 18).save(
        4, tree, extra_meta={"arch": _elastic_cfg().model.name})
    want = _ckpt_files(cluster, 4)
    got = np.load(out / "elastic_files.npz")
    assert sorted(got.files) == sorted(want)
    for name, data in want.items():
        assert got[name].tobytes() == data, name


if __name__ == "__main__":
    worker(int(sys.argv[1]), pathlib.Path(sys.argv[2]))
