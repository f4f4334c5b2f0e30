"""The port's tracer (`repro_torch.trace`) on the CPU.

* Off (the default), no path enters a `record_function`: a tiny
  phi3.5-moe, zamba2 and granite-4.0-h-small prefill, a Trainer's batch
  and 2-microbatch train step, and a checkpoint save, stripe loss,
  parity-rebuild restore and retain.
* On, each path opens exactly the spans its layers own, every one named
  in `trace.SPANS`, and gives the same bits as off: outputs, parameters,
  moments and checkpoint files.
* The counters: `moe.kept` is the dispatch's kept assignments on both
  dispatch paths, and `ckpt.host_bytes` the state's bytes.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs import granite4_h_small  # noqa: E402
from repro_torch.core import LustreCluster  # noqa: E402
from repro_torch.fsio import LustreClient  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe, registry  # noqa: E402
from repro_torch.models.config import RunConfig  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

SRC = pathlib.Path(trace.__file__).resolve().parent


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


# ------------------------------------------------------------- the paths

def _prefill(arch):
    cfg = (granite4_h_small.SMOKE if arch == "granite-4.0-h-small"
           else get_smoke_config(arch))
    rc = RunConfig(seq_len=128, global_batch=1, kind="prefill",
                   param_dtype="bfloat16", attn_impl="flash", ssm_chunk=32)
    gen = torch.Generator().manual_seed(0)
    params = L.tree_init(registry.param_defs(cfg), gen, torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (1, rc.seq_len), generator=gen,
                         dtype=torch.int32)
    tok, cache = steps.build_prefill_step(cfg, rc, device="cpu")(
        params, {"tokens": toks})
    return {"next": tok, **cache}


def _train():
    """A Trainer's batch from its store and one step of 2 microbatches,
    the gradients taken in bf16 (one cast of the parameters)."""
    cfg = get_smoke_config("phi3.5-moe")
    rc = RunConfig(seq_len=32, global_batch=4, kind="train",
                   num_microbatches=2, grad_reduce_dtype="bfloat16")
    cluster = LustreCluster(osts=2, mdses=1, clients=1, device="cpu",
                            commit_interval=64)
    tr = Trainer(cluster, TrainerConfig(model=cfg, rc=rc, dataset_seqs=8,
                                        n_writers=1))
    tr.init_state()
    params, opt, m = tr.step_fn(tr.params, tr.opt_state, tr._batch(0))
    out = {f"p.{'.'.join(k)}": v for k, v in L.tree_items(params)}
    out.update({f"m.{'.'.join(k)}": v for k, v in L.tree_items(opt["m"])})
    out.update({f"v.{'.'.join(k)}": v for k, v in L.tree_items(opt["v"])})
    return {**out, **m}


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(64, 96, generator=g),
                       "h": torch.randn(40, 33, generator=g).to(
                           torch.bfloat16)},
            "opt": {"step": torch.tensor(5, dtype=torch.int32),
                    "m": torch.randn(40, 33, generator=g)}}


def _ckpt():
    """Save two steps with parity, lose a stripe of the latest's `w`,
    restore it (a rebuild), keep one.  Returns every file's bytes of the
    latest step, as saved, and the restored leaves."""
    c = LustreCluster(osts=4, mdses=1, clients=2, device="cpu",
                      commit_interval=32)
    w = [LustreClient(c, i).mount() for i in range(2)]
    cm = CheckpointManager(w, stripe_count=3, stripe_size=4096, parity=True)
    cm.save(1, _state(1))
    cm.save(2, _state())
    d = "/ckpt/step_00000002"
    files = {}
    for name in sorted(w[0].readdir(d)):
        fh = w[0].open(f"{d}/{name}")
        files[name] = w[0].read(fh, 1 << 24)
        w[0].close(fh)
    ea = w[0].lmv.getattr(w[0].resolve(f"{d}/params.w.bin"),
                          want_ea=True)["ea"]["lov"]
    lost = ea["objects"][1]
    tgt = next(x for x in c.ost_targets if x.uuid == lost["ost"])
    tgt.obd.objects.pop((lost["group"], lost["oid"]))
    for fs in w:                          # a cold read: no cached pages
        for osc in fs.lov.oscs:
            osc.locks.cancel_all()
    got, _ = cm.restore()
    assert c.stats.counters["ckpt.stripe_reconstructed"] == 1
    cm.retain(keep=1)
    assert cm.steps() == [2]
    return {**files, **{k: v if isinstance(v, torch.Tensor)
                        else torch.from_numpy(np.array(v))
                        for k, v in got.items()}}


PATHS = {"phimoe_prefill": lambda: _prefill("phi3.5-moe"),
         "zamba2_prefill": lambda: _prefill("zamba2-7b"),
         "granite_prefill": lambda: _prefill("granite-4.0-h-small"),
         "train": _train, "ckpt": _ckpt}

SPANS_OF = {
    "phimoe_prefill": {"rt:prefill.forward", "rt:prefill.head", "rt:attn",
                       "rt:attn.kernel", "rt:moe", "rt:moe.route",
                       "rt:moe.dispatch", "rt:moe.experts",
                       "rt:moe.combine"},
    "zamba2_prefill": {"rt:prefill.forward", "rt:prefill.head", "rt:mamba",
                       "rt:mamba.ssd", "rt:attn", "rt:attn.kernel",
                       "rt:mlp"},
    "granite_prefill": {"rt:prefill.forward", "rt:prefill.head", "rt:mamba",
                        "rt:mamba.ssd", "rt:attn", "rt:attn.kernel",
                        "rt:moe", "rt:moe.route", "rt:moe.dispatch",
                        "rt:moe.experts", "rt:moe.combine",
                        "rt:moe.shared"},
    "train": {"rt:data.read", "rt:data.to_device", "rt:train.cast",
              "rt:train.forward", "rt:train.backward",
              "rt:train.accumulate", "rt:optim.adamw", "rt:attn",
              "rt:attn.kernel", "rt:moe", "rt:moe.route", "rt:moe.dispatch",
              "rt:moe.experts", "rt:moe.combine"},
    "ckpt": {"rt:ckpt.save", "rt:ckpt.host", "rt:ckpt.write",
             "rt:ckpt.parity", "rt:ckpt.commit", "rt:ckpt.restore",
             "rt:ckpt.read", "rt:ckpt.rebuild", "rt:ckpt.decode",
             "rt:ckpt.retain"},
}


def _raise(*a, **k):
    raise AssertionError("record_function entered with tracing off")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_off_enters_no_record_function(path, monkeypatch):
    monkeypatch.setattr(trace, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    PATHS[path]()
    assert trace.counters() == {"flash.launches": 0, "parity.launches": 0,
                                "ssd.launches": 0}


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], bytes):
            assert a[k] == b[k], k
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("path", sorted(PATHS))
def test_on_opens_its_spans_and_changes_no_bit(path):
    off = PATHS[path]()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = PATHS[path]()
    trace.disable()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {n for n in names if n.startswith("rt:")} == SPANS_OF[path]
    _same(off, on)


def test_every_span_and_counter_is_listed_and_used():
    assert all(n.startswith("rt:") for n in trace.SPANS)
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    used_spans, used_counters = set(), set()
    for f in SRC.rglob("*.py"):
        text = f.read_text()
        used_spans |= set(re.findall(r'trace\.span\("([^"]+)"\)', text))
        used_counters |= set(re.findall(
            r'trace\.add(?:_device)?\(\s*"([^"]+)"', text))
    assert used_spans == set(trace.SPANS)
    assert used_counters == set(trace.COUNTERS)
    assert set().union(*SPANS_OF.values()) == set(trace.SPANS)
    trace.enable()
    with pytest.raises(ValueError):
        trace.span("rt:unlisted")
    with pytest.raises(ValueError):
        trace.add("unlisted", 1)


# ------------------------------------------------------------ the counters

def _moe_case():
    """Layer inputs whose router sends most tokens to expert 0 first, so
    that expert overflows and assignments drop."""
    cfg = get_smoke_config("phi3.5-moe")
    g = torch.Generator().manual_seed(3)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"router": torch.randn(d, E, generator=g) * 0.1,
         "wg": torch.randn(E, d, f, generator=g) * 0.1,
         "wu": torch.randn(E, d, f, generator=g) * 0.1,
         "wd": torch.randn(E, f, d, generator=g) * 0.1}
    p["router"][:, 0] += 0.05
    x = torch.randn(96, d, generator=g) + 1.0
    return cfg, p, x, RunConfig(seq_len=96, global_batch=1, kind="prefill",
                                compute_dtype="float32")


def test_moe_kept_is_the_dispatch_kept_count():
    cfg, p, x, rc = _moe_case()
    T, k, E = x.shape[0], cfg.top_k, cfg.n_experts
    C = moe.capacity(cfg, T)
    _, top_e, _ = moe.route(cfg, p, x)
    _, _, keep = moe.dispatch(cfg, top_e, C)
    trace.enable()
    stats = {}
    moe._moe_ffn_global(cfg, p, x, rc, stats)
    got = trace.counters()
    assert stats["dropped"] > 0
    assert got["moe.kept"] == int(keep.sum()) == T * k - stats["dropped"]
    assert got["moe.assignments"] == T * k
    assert got["moe.slots"] == E * C


def test_moe_kept_on_the_shard_local_path():
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    cfg, p, x, rc = _moe_case()
    T, k = x.shape[0], cfg.top_k
    dryrun.fake_group(1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        trace.enable()
        stats = {}
        moe.moe_ffn_sharded(cfg, p, x, rc, mesh, stats)
        got = trace.counters()
    finally:
        torch.distributed.destroy_process_group()
    assert stats["dropped"] > 0
    assert stats["dropped"] == got["moe.assignments"] - got["moe.kept"]
    assert got["moe.assignments"] == T * k
    assert got["moe.slots"] == cfg.n_experts * moe.capacity(cfg, T)


def test_ckpt_counters_are_the_state_bytes():
    state = _state()
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*state["params"].values(),
                           *state["opt"].values()))
    c = LustreCluster(osts=4, mdses=1, clients=1, device="cpu",
                      commit_interval=32)
    fs = LustreClient(c, 0).mount()
    cm = CheckpointManager([fs], stripe_count=3, stripe_size=4096,
                           parity=True)
    trace.enable()
    manifest = cm.save(1, state)
    got = trace.counters()
    assert got["ckpt.host_bytes"] == nbytes
    parity = 0
    for name, e in manifest["leaves"].items():
        fh = fs.open(f"/ckpt/step_00000001/{name}.parity")
        parity += len(fs.read(fh, 1 << 24))
        fs.close(fh)
    assert got["ckpt.write_bytes"] == nbytes + parity
    trace.reset()
    cm.restore(1)
    got = trace.counters()
    assert got["ckpt.read_bytes"] == nbytes
    assert "ckpt.rebuilt" not in got
