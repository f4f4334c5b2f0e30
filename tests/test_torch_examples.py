"""The port's entry points: its examples (`repro_torch.examples`) and its
checkpoint and parity benchmarks (`repro_torch.tools`), against the
reference's.

* Each example run as a user runs it, `python -m ... --device cpu`, in
  a subprocess, and each benchmark's command line with its results kept
  out of `results/`; without a card the default device ("cuda")
  raises.
* quickstart and failover_demo print what the reference's scripts print,
  line for line, apart from failover_demo's one line that names the
  kernel.
* train_e2e's `run()` at a narrow model and 4 steps against the same
  script body on the reference `Trainer` (a (1, 1) mesh of Auto axes,
  ROADMAP R1), both from the same initial state in float32: losses
  within 1e-4 relative, and equal storage numbers (MiB written and read,
  timeouts, replays, virtual seconds, checkpoint steps, resume step).
* serve_batched's `run()` against the reference `Trainer` plus
  `BatchedServer`, from the same initial state in float32: equal losses
  within 1e-4, equal tokens and equal KiB of weights read.
* bench_checkpoint's dict equal to the reference's `run()`, exactly
  (virtual-time MB/s), and bench_parity's kernel half bit-exact against
  `repro.kernels.ref`.

Runs that compare virtual time start each package's id sequences afresh
(ROADMAP R6).
"""
import contextlib
import dataclasses
import io
import itertools
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dlm as port_dlm  # noqa: E402
from repro_torch.core import llog as port_llog  # noqa: E402
from repro_torch.core import ptlrpc as port_rpc  # noqa: E402
from repro_torch.core import sanitize as port_sanitize  # noqa: E402
from repro_torch.examples import failover_demo, quickstart  # noqa: E402
from repro_torch.examples import serve_batched, train_e2e  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.tools import bench_checkpoint, bench_parity  # noqa: E402

try:
    import jax
    from jax.sharding import AxisType
    from repro.core import LustreCluster as RefCluster
    from repro.core import dlm as ref_dlm
    from repro.core import llog as ref_llog
    from repro.core import ptlrpc as ref_rpc
    from repro.models.config import ModelConfig as RefModelConfig
    from repro.models.config import RunConfig as RefRunConfig
    from repro.parallel import shardings as ref_shardings
    from repro.train.serve import BatchedServer as RefServer
    from repro.train.trainer import Trainer as RefTrainer
    from repro.train.trainer import TrainerConfig as RefTrainerConfig
except ImportError:                      # pragma: no cover
    jax = None

REPO = pathlib.Path(__file__).resolve().parents[1]
F32_REL = 1e-4
# a narrow stand-in for train_e2e's models: the reference computes its
# checkpoints' parity with the Pallas kernel in interpret mode on the CPU
NARROW = dict(name="e2e-narrow", family="transformer", n_layers=2,
              d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
              vocab=256)


@pytest.fixture(autouse=True)
def _port_sanitizer_guard():
    before = len(port_sanitize.state.violations)
    yield
    new = port_sanitize.state.violations[before:]
    assert not new, "port sanitizer violations:\n" + "\n".join(
        v.render() for v in new)


def run_module(*argv, timeout=300) -> str:
    """stdout of `python argv` from the repo's root; one intra-op thread,
    as the tests run beside other workers."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


# --------------------------------------------------- as a user runs them

@pytest.mark.parametrize("module,args,expect", [
    ("repro_torch.examples.quickstart", [], "virtual time elapsed"),
    ("repro_torch.examples.failover_demo", [],
     "all six failure modes recovered"),
    ("repro_torch.examples.serve_batched", [],
     "weights read from the striped store"),
    ("repro_torch.examples.train_e2e",
     ["--steps", "4", "--batch", "2", "--seq", "32"], "storage: wrote"),
], ids=["quickstart", "failover_demo", "serve_batched", "train_e2e"])
def test_entry_point_runs_on_the_cpu(module, args, expect):
    assert expect in run_module("-m", module, *args, "--device", "cpu")


@pytest.mark.parametrize("tool,expect", [
    (bench_checkpoint, "checkpoint bandwidth"),
    (bench_parity, "raid5 end-to-end")], ids=["bench_checkpoint",
                                              "bench_parity"])
def test_benchmark_runs_on_the_cpu(tool, expect):
    """The benchmark's command line, its results kept out of results/."""
    saved = {}
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()) as out:
        mp.setattr(tool, "save", lambda name, payload: saved.update(
            {name: payload}))
        tool.main(["--device", "cpu"])
    assert expect in out.getvalue()
    assert list(saved) == [f"torch_{tool.__name__.rsplit('_', 1)[-1]}"]


@pytest.mark.parametrize("main", [
    quickstart.main, failover_demo.main, serve_batched.main, train_e2e.main,
    bench_checkpoint.main, bench_parity.main],
    ids=["quickstart", "failover_demo", "serve_batched", "train_e2e",
         "bench_checkpoint", "bench_parity"])
def test_entry_point_on_card_without_one_raises(main):
    """"cuda" is the default, and without a card it raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"), \
            contextlib.redirect_stdout(io.StringIO()):
        main([])


# ------------------------------------------------ printed like the reference

@pytest.mark.parametrize("script", ["quickstart", "failover_demo"])
def test_example_prints_what_the_reference_prints(script):
    pytest.importorskip("repro.core")
    want = run_module(str(REPO / "examples" / f"{script}.py")).splitlines()
    got = run_module("-m", f"repro_torch.examples.{script}", "--device",
                     "cpu").splitlines()
    assert len(got) == len(want)
    differ = [(w, g) for w, g in zip(want, got) if w != g]
    if script == "quickstart":
        assert differ == []
    else:                          # the line that names the parity kernel
        assert len(differ) == 1
        w, g = differ[0]
        assert "Pallas" in w and "csrc/xor_parity.cu" in g
        assert w.split("XOR parity")[0] == g.split("XOR parity")[0]


def test_failover_demo_makes_one_parity_call():
    """Step 6 saves one leaf of 3 stripes with parity; its restore reads
    the leaf from the writer's cache, so no stripe is rebuilt (the line
    prints "None stripe", as the reference's does)."""
    calls = []
    real = ops.parity_bytes

    def counted(chunks, *, device):
        calls.append(len(chunks))
        return real(chunks, device=device)
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()) as out:
        mp.setattr(ops, "parity_bytes", counted)
        failover_demo.main(["--device", "cpu"])
    assert calls == [3]
    assert "(None stripe," in out.getvalue()


# --------------------------------------------------- against the reference

@pytest.fixture
def ref_mesh():
    if jax is None:
        pytest.skip("needs jax for the reference trainer")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    yield mesh
    ref_shardings.set_ambient_mesh(None)


@contextlib.contextmanager
def fresh_ids(mods):
    """A package's process-wide id sequences started afresh."""
    dlm, llog, rpc = mods
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rpc.RpcClient, "_uuid_seq", itertools.count(0))
        mp.setattr(rpc, "_trace_seq", itertools.count(1))
        mp.setattr(dlm, "_handle_seq", itertools.count(1))
        mp.setattr(llog, "_cookie_seq", itertools.count(1))
        yield


def ref_state(tr) -> dict:
    return jax.tree.map(np.array, {"params": tr.params,
                                   "opt": tr.opt_state})


def ref_train_e2e(mesh, model, steps, batch, seq) -> tuple[dict, dict]:
    """The body of examples/train_e2e.py on the reference Trainer (the
    script itself fails on the installed JAX, ROADMAP R1), in float32;
    returns its initial state and its printed numbers."""
    cluster = RefCluster(osts=4, mdses=1, clients=2, ost_failover=True,
                         commit_interval=64)
    cfg = RefTrainerConfig(
        model=model, rc=RefRunConfig(seq_len=seq, global_batch=batch,
                                     kind="train", attn_impl="ref",
                                     compute_dtype="float32"),
        n_steps=steps, ckpt_every=max(10, steps // 10), dataset_seqs=4096,
        n_writers=2, parity=True)
    half = steps // 2
    tr = RefTrainer(cluster, cfg, mesh=mesh).init_state()
    init = ref_state(tr)
    tr.run(half, fail_at={half // 2: lambda c: c.fail_node("ost1")})
    first, ckpts = [m["loss"] for m in tr.metrics], tr.ckpt.steps()
    del tr
    tr2 = RefTrainer.resume(cluster, cfg, mesh=mesh)
    resumed = tr2.step
    tr2.run(steps - tr2.step)
    st = cluster.stats
    return init, {
        "losses_first": first, "checkpoints": ckpts, "resumed_at": resumed,
        "losses_after": [m["loss"] for m in tr2.metrics],
        "final_step": tr2.step, "ckpt_steps": tr2.ckpt.steps(),
        "vtime_s": cluster.now,
        "wrote_mib": st.bytes.get("ost.write", 0) >> 20,
        "read_mib": st.bytes.get("ost.read", 0) >> 20,
        "timeouts": st.counters.get("rpc.timeout", 0),
        "replays": st.counters.get("rpc.replay", 0)}


def test_train_e2e_matches_reference_trainer(ref_mesh):
    args = types.SimpleNamespace(steps=4, batch=4, seq=32, large=False)
    with fresh_ids((ref_dlm, ref_llog, ref_rpc)):
        init, want = ref_train_e2e(ref_mesh, RefModelConfig(**NARROW),
                                   args.steps, args.batch, args.seq)
    with fresh_ids((port_dlm, port_llog, port_rpc)):
        got = train_e2e.run(args, ModelConfig(**NARROW), device="cpu",
                            compute_dtype="float32", state=init)
    assert got["model"] == "e2e-narrow" and got["half"] == 2
    assert got["checkpoints"] == want["checkpoints"] == [2]
    assert got["resumed_at"] == want["resumed_at"] == 2
    assert got["ckpt_steps"] == want["ckpt_steps"] == [2, 4]
    for key in ("losses_first", "losses_after"):
        assert got[key] == pytest.approx(want[key], rel=F32_REL), key
    for key in ("final_step", "vtime_s", "wrote_mib", "read_mib",
                "timeouts", "replays"):
        assert got[key] == want[key], key


def test_serve_batched_matches_reference(ref_mesh):
    port_cfg = serve_batched.trainer_config("float32")
    with fresh_ids((ref_dlm, ref_llog, ref_rpc)):
        cluster = RefCluster(osts=4, mdses=1, clients=2, commit_interval=64)
        cfg = RefTrainerConfig(
            model=RefModelConfig(**dataclasses.asdict(port_cfg.model)),
            rc=RefRunConfig(**dataclasses.asdict(port_cfg.rc)),
            **{k: getattr(port_cfg, k) for k in (
                "n_steps", "ckpt_every", "dataset_seqs", "n_writers",
                "parity")})
        tr = RefTrainer(cluster, cfg, mesh=ref_mesh).init_state()
        init = ref_state(tr)
        tr.run()
        tr2 = RefTrainer.resume(cluster, cfg, mesh=ref_mesh)
        srv = RefServer(cfg.model, tr2.params, max_seq=64)
        srv.rc = dataclasses.replace(srv.rc, compute_dtype="float32")
        outs = srv.generate(serve_batched.requests())
        kib = cluster.stats.bytes.get("ost.read", 0) >> 10
    with fresh_ids((port_dlm, port_llog, port_rpc)):
        got = serve_batched.run("cpu", compute_dtype="float32", state=init)
    assert got["ckpt_steps"] == tr.ckpt.steps() == [10]
    assert got["losses"] == pytest.approx([m["loss"] for m in tr.metrics],
                                          rel=F32_REL)
    assert [r["out"] for r in got["outs"]] == [r.out for r in outs]
    assert got["weights_kib"] == kib


def test_bench_checkpoint_matches_reference():
    pytest.importorskip("jax")
    from benchmarks import bench_checkpoint as ref_bench
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(ref_bench, "save", lambda *a: None)
        mp.setattr(bench_checkpoint, "save", lambda *a: None)
        with fresh_ids((ref_dlm, ref_llog, ref_rpc)):
            want = ref_bench.run()
        with fresh_ids((port_dlm, port_llog, port_rpc)):
            got = bench_checkpoint.run("cpu")
    assert list(got) == ["w1_s1", "w1_s4", "w2_s4", "w4_s4", "w4_s8",
                         "w4_s4_p"]
    assert got == want


def test_bench_parity_kernel_half_is_bit_exact():
    """The port's rows at a small N: the kernel (its plain version here)
    against `repro.kernels.ref` on the same draw, and the bound at the
    H100's memory rate."""
    pytest.importorskip("jax")
    from repro.kernels import ref as jref
    n = 4096
    rows = bench_parity.kernel_half("cpu", n=n)
    rng = np.random.default_rng(0)
    for k in bench_parity.STRIPES:
        blocks = rng.integers(-2**31, 2**31, size=(k, n), dtype=np.int32)
        got = bench_parity.parity.xor_parity(torch.from_numpy(blocks))
        assert np.array_equal(got.numpy(),
                              np.asarray(jref.xor_parity_ref(blocks)))
        r = rows[k]
        assert r["bit_exact"] and "kernel_s" not in r
        assert r["bytes_moved"] == (k + 1) * n * 4
        assert r["bound_s"] == r["bytes_moved"] / 3.35e12
        assert r["arith_intensity_ops_per_byte"] == round(
            (k - 1) / ((k + 1) * 4), 4)
