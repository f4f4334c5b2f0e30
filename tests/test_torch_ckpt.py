"""The port's checkpoint manager and data pipeline, and the checkpoint
against the reference's.

* Twins of tests/test_ckpt.py and of the int8 checkpoint tests of
  tests/test_extensions.py, on a port cluster with parity on the CPU.
* Leaves as torch tensors: float32, int32 scalars and bfloat16 (stored
  by its raw bytes under the dtype name "bfloat16").
* Cross tests: the same tree saved by both packages on two fresh,
  identical clusters stores the same object bytes, manifest, ckpt.* and
  ost.* counters and virtual time.  A checkpoint saved by one package
  restores through the other's manager, both ways, including a stripe
  rebuilt from parity.  The managers take the other package's clients:
  they call only client methods and their own package's LOV helpers.
* On a card (skipped here): a save and a restore with parity on the
  card, a lost stripe rebuilt by the kernel.
"""
import contextlib
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core import LustreCluster  # noqa: E402
from repro_torch.core import dlm as port_dlm  # noqa: E402
from repro_torch.core import llog as port_llog  # noqa: E402
from repro_torch.core import ptlrpc as port_rpc  # noqa: E402
from repro_torch.core import sanitize as port_sanitize  # noqa: E402
from repro_torch.data import TokenDataset, TokenPipeline  # noqa: E402
from repro_torch.fsio import LustreClient  # noqa: E402
from repro_torch.kernels import parity as port_parity  # noqa: E402

try:                                     # the card tests need no JAX
    import jax.numpy as jnp
    from repro.ckpt import CheckpointManager as RefManager
    from repro.core import LustreCluster as RefCluster
    from repro.core import dlm as ref_dlm
    from repro.core import llog as ref_llog
    from repro.core import ptlrpc as ref_rpc
    from repro.fsio import LustreClient as RefClient
except ImportError:                      # pragma: no cover
    jnp = None


@pytest.fixture(autouse=True)
def _port_sanitizer_guard():
    before = len(port_sanitize.state.violations)
    yield
    new = port_sanitize.state.violations[before:]
    assert not new, "port sanitizer violations:\n" + "\n".join(
        v.render() for v in new)


@pytest.fixture
def reference():
    if jnp is None:
        pytest.skip("needs jax for the reference package")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the parity kernel has no CPU mode")
    return "cuda"


def mk(osts=4, clients=2, parity=True, device="cpu", **kw):
    c = LustreCluster(osts=osts, mdses=1, clients=clients, device=device,
                      commit_interval=kw.pop("commit_interval", 32))
    writers = [LustreClient(c, i % clients).mount() for i in range(clients)]
    cm = CheckpointManager(writers, stripe_count=min(3, osts),
                           stripe_size=4096, parity=parity, **kw)
    return c, writers, cm


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((32, 48)).astype(np.float32),
                  "b": rng.standard_normal(48).astype(np.float32)},
            "c": rng.integers(0, 100, 17).astype(np.int32)}


def drop_stripe(c, fs, path, slot):
    """Lose one stripe object of `path` (a dead OST disk)."""
    ea = fs.lmv.getattr(fs.resolve(path), want_ea=True)["ea"]["lov"]
    victim = ea["objects"][slot]
    tgt = next(x for x in c.ost_targets if x.uuid == victim["ost"])
    tgt.obd.objects.pop((victim["group"], victim["oid"]))


def drop_caches(clients):
    """Cancel the clients' locks, so that a restore reads cold: the
    lock-covered clean caches of the writers would (correctly) mask a
    lost object."""
    for fs in clients:
        for osc in fs.lov.oscs:
            osc.locks.cancel_all()


# ----------------------------------------------- twins of test_ckpt.py

def test_save_restore_roundtrip():
    c, w, cm = mk()
    t = tree()
    cm.save(10, t)
    got, m = cm.restore()
    assert m["step"] == 10
    assert (got["a.w"] == t["a"]["w"]).all()
    assert (got["a.b"] == t["a"]["b"]).all()
    assert (got["c"] == t["c"]).all()
    assert got["c"].dtype == np.int32


def test_latest_picks_max_complete():
    c, w, cm = mk()
    cm.save(1, tree(1))
    cm.save(5, tree(5))
    cm.save(3, tree(3))
    assert cm.latest() == 5
    got, _ = cm.restore(3)
    assert (got["c"] == tree(3)["c"]).all()


def test_manifest_is_commit_record():
    """A step dir without MANIFEST (writer died mid-save) is invisible to
    restore and removed by cleanup."""
    c, w, cm = mk()
    cm.save(1, tree())
    fs = w[0]
    fs.mkdir_p("/ckpt/step_00000009")
    fh = fs.creat("/ckpt/step_00000009/partial.bin")
    fs.write(fh, b"junk" * 100)
    fs.close(fh)
    assert cm.latest() == 1
    removed = cm.cleanup_incomplete()
    assert removed == ["step_00000009"]
    assert not fs.exists("/ckpt/step_00000009")


def test_parity_reconstructs_lost_stripe():
    c, w, cm = mk()
    t = tree()
    cm.save(2, t)
    drop_stripe(c, w[0], "/ckpt/step_00000002/a.w.bin", 2)
    got, _ = cm.restore(2)
    assert (got["a.w"] == t["a"]["w"]).all()
    assert c.stats.counters["ckpt.stripe_reconstructed"] == 1


def test_no_parity_fails_on_lost_stripe():
    c, w, cm = mk(parity=False)
    cm.save(2, tree())
    drop_stripe(c, w[0], "/ckpt/step_00000002/a.w.bin", 0)
    # the writers' lock-covered clean caches would (correctly!) mask the
    # lost object - drop the locks so the restore reads cold
    for fs_ in w:
        for osc in fs_.lov.oscs:
            osc.locks.cancel_all()
    with pytest.raises(Exception):
        cm.restore(2)


def test_retain_deletes_old():
    c, w, cm = mk()
    for s in (1, 2, 3, 4, 5):
        cm.save(s, {"x": np.ones(4, np.float32)})
    cm.retain(2)
    assert cm.steps() == [4, 5]


def test_checkpoint_survives_ost_crash_during_save():
    """OST crashes after a save: replay makes the save still complete."""
    c, w, cm = mk(commit_interval=10_000)
    t = tree()
    cm.save(7, t)
    c.fail_node("ost1")
    c.restart_node("ost1")
    got, _ = cm.restore(7)
    assert (got["a.w"] == t["a"]["w"]).all()


def test_pipeline_deterministic_and_disjoint():
    c = LustreCluster(osts=4, mdses=1, clients=1, commit_interval=64,
                      device="cpu")
    fs = LustreClient(c).mount()
    ds = TokenDataset(fs, vocab=500, seq_len=32, n_seqs=128,
                      stripe_count=4).build()
    pipes = [TokenPipeline(fs, ds, dp_rank=i, dp_size=4, batch_per_rank=4)
             for i in range(4)]
    seen = []
    for p in pipes:
        idx = p.indices_for(3)
        assert (p.batch_at(3) == p.batch_at(3)).all()
        seen.append(set(idx.tolist()))
    allidx = set().union(*seen)
    assert len(allidx) == sum(len(s) for s in seen)   # disjoint shards


def test_pipeline_epoch_reshuffles():
    c = LustreCluster(osts=2, mdses=1, clients=1, commit_interval=64,
                      device="cpu")
    fs = LustreClient(c).mount()
    ds = TokenDataset(fs, vocab=500, seq_len=16, n_seqs=64).build()
    p = TokenPipeline(fs, ds, dp_rank=0, dp_size=1, batch_per_rank=8)
    e0 = [tuple(p.indices_for(s)) for s in range(p.per_epoch)]
    e1 = [tuple(p.indices_for(s + p.per_epoch)) for s in range(p.per_epoch)]
    assert sorted(sum(e0, ())) == sorted(sum(e1, ()))  # same coverage
    assert e0 != e1                                    # different order


def test_pipeline_tokens_match_dataset_bytes():
    c = LustreCluster(osts=2, mdses=1, clients=1, commit_interval=64,
                      device="cpu")
    fs = LustreClient(c).mount()
    ds = TokenDataset(fs, vocab=500, seq_len=16, n_seqs=64, seed=3).build()
    p = TokenPipeline(fs, ds, dp_rank=0, dp_size=1, batch_per_rank=4)
    rng = np.random.default_rng(3)
    all_tokens = rng.integers(0, 500, size=(64, 16), dtype=np.int32)
    batch = p.batch_at(0)
    idx = p.indices_for(0)
    assert (batch == all_tokens[idx]).all()


# ------------------------------- twins of the int8 checkpoint tests

def test_quantized_checkpoint_roundtrip():
    c = LustreCluster(osts=2, mdses=1, clients=1, commit_interval=32,
                      device="cpu")
    fs = [LustreClient(c).mount()]
    cm = CheckpointManager(fs, stripe_count=2, stripe_size=4096,
                           quantize="int8")
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((128, 64)) * 0.02).astype(np.float32)
    ints = rng.integers(0, 100, 50).astype(np.int32)
    cm.save(1, {"w": w, "step_ids": ints})
    got, m = cm.restore(1)
    # int tensors stored exactly; float tensors within int8 block error
    assert (got["step_ids"] == ints).all()
    rel = np.abs(got["w"] - w).max() / np.abs(w).max()
    assert rel < 0.02, rel
    # compression actually happened (~4x smaller than f32)
    assert m["leaves"]["w"]["bytes"] < w.nbytes // 3


def test_quantized_vs_raw_bytes_on_wire():
    c1 = LustreCluster(osts=2, mdses=1, clients=1, commit_interval=512,
                       device="cpu")
    c2 = LustreCluster(osts=2, mdses=1, clients=1, commit_interval=512,
                       device="cpu")
    arr = {"w": np.random.default_rng(1).standard_normal(
        (256, 256)).astype(np.float32)}
    CheckpointManager([LustreClient(c1).mount()]).save(1, arr)
    CheckpointManager([LustreClient(c2).mount()],
                      quantize="int8").save(1, arr)
    raw = c1.stats.bytes["ost.write"]
    q = c2.stats.bytes["ost.write"]
    assert q < raw / 3


# ------------------------------------------------------ tensor leaves

def tensor_tree(seed=0):
    """A trainer-like state of tensors: f32, an int32 scalar, bf16."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(40, 33, generator=g),
                       "h": torch.randn(7, 300, generator=g).to(
                           torch.bfloat16)},
            "opt": {"step": torch.tensor(5, dtype=torch.int32),
                    "m": torch.randn(40, 33, generator=g)}}


@pytest.mark.parametrize("parity", [False, True])
def test_tensor_leaves_roundtrip(parity):
    c, w, cm = mk(parity=parity)
    t = tensor_tree()
    t["params"]["w"].requires_grad_()           # detached on the way out
    m = cm.save(3, t)
    assert m["leaves"]["params.h"]["dtype"] == "bfloat16"
    assert m["leaves"]["opt.step"] == {"shape": [], "dtype": "int32",
                                       "bytes": 4, "writer": 1,
                                       **({"parity": True} if parity
                                          else {})}
    got, _ = cm.restore(3)
    assert isinstance(got["params.h"], torch.Tensor)
    assert got["params.h"].dtype == torch.bfloat16
    assert torch.equal(got["params.h"], t["params"]["h"])
    assert np.array_equal(got["params.w"], t["params"]["w"].detach().numpy())
    assert got["opt.step"].dtype == np.int32 and got["opt.step"] == 5
    assert np.array_equal(got["opt.m"], t["opt"]["m"].numpy())


def test_bf16_leaf_reconstructed_from_parity():
    c, w, cm = mk()
    h = torch.randn(64, 96, generator=torch.Generator().manual_seed(4)
                    ).to(torch.bfloat16)
    cm.save(1, {"h": h})
    drop_stripe(c, w[0], "/ckpt/step_00000001/h.bin", 1)
    drop_caches(w)
    got, _ = cm.restore(1)
    assert torch.equal(got["h"], h)
    assert c.stats.counters["ckpt.stripe_reconstructed"] == 1


def test_quantized_tensor_leaves():
    c, w, cm = mk(quantize="int8")
    t = tensor_tree()
    m = cm.save(1, t)
    assert m["leaves"]["params.w"]["quant"]["orig_dtype"] == "float32"
    assert "quant" not in m["leaves"]["params.h"]       # not a numpy float
    got, _ = cm.restore(1)
    want = t["params"]["w"].numpy()
    assert np.abs(got["params.w"] - want).max() < 0.02 * np.abs(want).max()
    assert torch.equal(got["params.h"], t["params"]["h"])


def test_large_leaf_stripe_rebuilt_from_rpc_sized_reads():
    """A lost stripe of a 128 MiB leaf (objects of 44.8 MB) is rebuilt:
    the surviving objects are read in 4 MiB BRW RPCs.  (The reference
    reads each in one RPC, which times out at this size: ROADMAP R9.)"""
    c = LustreCluster(osts=4, mdses=1, clients=2, commit_interval=64,
                      max_cached_mb=0, device="cpu")
    w = [LustreClient(c, i).mount() for i in range(2)]
    cm = CheckpointManager(w, stripe_count=3, stripe_size=1 << 18,
                           parity=True)
    big = np.random.default_rng(0).standard_normal(32 << 20).astype(
        np.float32)
    cm.save(1, {"e": big})
    drop_stripe(c, w[0], "/ckpt/step_00000001/e.bin", 1)
    rpcs = c.stats.counters["osc.brw_read_rpc"]
    got, _ = cm.restore(1)
    assert np.array_equal(got["e"], big)
    assert c.stats.counters["ckpt.stripe_reconstructed"] == 1
    assert c.stats.counters["osc.brw_read_rpc"] - rpcs >= 2 * 10


def test_manager_device_defaults_to_the_clusters():
    c, w, cm = mk()
    assert cm.device == torch.device("cpu") == c.device


# ------------------------------------------------- against the reference

@contextlib.contextmanager
def fresh_ids(mods):
    """Run with a package's process-wide id sequences started afresh
    (client uuids count on the wire, so virtual time depends on them)."""
    dlm, llog, rpc = mods
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rpc.RpcClient, "_uuid_seq", itertools.count(0))
        mp.setattr(rpc, "_trace_seq", itertools.count(1))
        mp.setattr(dlm, "_handle_seq", itertools.count(1))
        mp.setattr(llog, "_cookie_seq", itertools.count(1))
        yield


def stored_objects(c) -> dict:
    """Every object on every OST target: (uuid, group, oid) -> bytes."""
    out = {}
    for t in c.ost_targets:
        for key in sorted(t.obd.objects):
            size = t.obd.getattr(*key)["size"]
            out[(t.uuid, *key)] = t.obd.read(*key, 0, size)
    return out


def cross_tree(seed=0):
    """The same leaves in each package's form: numpy (f32, an int32
    scalar) for both, and bf16 as a jax array / a torch tensor."""
    rng = np.random.default_rng(seed)
    base = {"a": {"w": rng.standard_normal((64, 100)).astype(np.float32),
                  "b": rng.standard_normal(100).astype(np.float32)},
            "step": np.asarray(7, np.int32)}
    h = rng.standard_normal((50, 70)).astype(np.float32)
    port = {**base, "h": torch.from_numpy(h).to(torch.bfloat16)}
    ref = {**base, "h": jnp.asarray(h, jnp.bfloat16)}
    return ref, port


def _save_on_fresh(ref: bool, tree, **kw):
    mods = (ref_dlm, ref_llog, ref_rpc) if ref else (port_dlm, port_llog,
                                                     port_rpc)
    with fresh_ids(mods):
        if ref:
            c = RefCluster(osts=4, mdses=1, clients=2, commit_interval=32)
            w = [RefClient(c, i).mount() for i in range(2)]
            cm = RefManager(w, stripe_count=3, stripe_size=4096, **kw)
        else:
            c = LustreCluster(osts=4, mdses=1, clients=2,
                              commit_interval=32, device="cpu")
            w = [LustreClient(c, i).mount() for i in range(2)]
            cm = CheckpointManager(w, stripe_count=3, stripe_size=4096,
                                   **kw)
        m = cm.save(4, tree, extra_meta={"arch": "x"})
    counters = {k: v for k, v in c.stats.counters.items()
                if k.startswith(("ckpt.", "ost."))}
    return c, w, m, counters


@pytest.mark.parametrize("kw", [{"parity": True}, {"parity": False},
                                {"parity": True, "quantize": "int8"},
                                {"parity": True, "use_wbc": False}],
                         ids=["parity", "plain", "int8", "no_wbc"])
def test_same_tree_stores_same_bytes_as_reference(reference, kw):
    rtree, ptree = cross_tree()
    rc, rw, rm, rcount = _save_on_fresh(True, rtree, **kw)
    pc, pw, pm, pcount = _save_on_fresh(False, ptree, **kw)
    assert pm == rm
    assert json.dumps(pm).encode() == json.dumps(rm).encode()
    assert stored_objects(pc) == stored_objects(rc)
    assert pcount == rcount and pcount["ckpt.saved"] == 1
    assert pc.now == rc.now


@pytest.mark.parametrize("lose", [None, 0, 2])
def test_reference_checkpoint_restores_in_port(reference, lose):
    rtree, _ = cross_tree(1)
    rc, rw, _, _ = _save_on_fresh(True, rtree, parity=True)
    if lose is not None:
        drop_stripe(rc, rw[0], "/ckpt/step_00000004/a.w.bin", lose)
        drop_caches(rw)
    got, m = CheckpointManager(rw, parity=True, device="cpu").restore()
    assert m["step"] == 4 and m["arch"] == "x"
    assert np.array_equal(got["a.w"], rtree["a"]["w"])
    assert np.array_equal(got["a.b"], rtree["a"]["b"])
    assert got["step"].dtype == np.int32 and got["step"] == 7
    assert got["h"].dtype == torch.bfloat16
    assert np.array_equal(got["h"].float().numpy(),
                          np.asarray(rtree["h"], np.float32))
    assert rc.stats.counters.get("ckpt.stripe_reconstructed", 0) == (
        lose is not None)


@pytest.mark.parametrize("lose", [None, 1])
def test_port_checkpoint_restores_in_reference(reference, lose):
    _, ptree = cross_tree(2)
    pc, pw, _, _ = _save_on_fresh(False, ptree, parity=True)
    if lose is not None:
        drop_stripe(pc, pw[0], "/ckpt/step_00000004/a.w.bin", lose)
        drop_caches(pw)
    got, m = RefManager(pw, parity=True).restore()
    assert m["step"] == 4
    assert np.array_equal(got["a.w"], ptree["a"]["w"])
    assert got["step"].dtype == np.int32 and got["step"] == 7
    assert str(got["h"].dtype) == "bfloat16"
    assert np.array_equal(np.asarray(got["h"], np.float32),
                          ptree["h"].float().numpy())
    assert pc.stats.counters.get("ckpt.stripe_reconstructed", 0) == (
        lose is not None)


def test_restore_matches_reference_restore_counts(reference):
    """Both managers restoring one checkpoint, each on its own identical
    cluster, read the same bytes in the same virtual time."""
    out = []
    for ref in (True, False):
        rtree, ptree = cross_tree(3)
        c, w, _, _ = _save_on_fresh(ref, rtree if ref else ptree,
                                    parity=True)
        drop_stripe(c, w[0], "/ckpt/step_00000004/a.w.bin", 1)
        drop_caches(w)
        mods = (ref_dlm, ref_llog, ref_rpc) if ref else (
            port_dlm, port_llog, port_rpc)
        with fresh_ids(mods):
            t0 = c.now
            mgr = (RefManager(w, parity=True) if ref else
                   CheckpointManager(w, parity=True))
            got, _ = mgr.restore()
        out.append((c.now - t0, dict(c.stats.counters),
                    np.asarray(got["a.w"])))
    (rt, rcnt, rw), (pt, pcnt, pw) = out
    assert pt == rt and pcnt == rcnt and np.array_equal(pw, rw)
    assert pcnt["ckpt.stripe_reconstructed"] == 1


# ------------------------------------------------------------- on a card

def test_save_restore_on_card_with_lost_stripe(cuda_device):
    c, w, cm = mk(device=cuda_device)
    t = tensor_tree(5)
    t = {k: {n: v.to(cuda_device) for n, v in d.items()}
         for k, d in t.items()}
    launches = port_parity.LAUNCHES
    m = cm.save(2, t)
    assert port_parity.LAUNCHES - launches == sum(
        1 for e in m["leaves"].values() if e.get("parity"))
    drop_stripe(c, w[0], "/ckpt/step_00000002/params.w.bin", 0)
    drop_caches(w)
    launches = port_parity.LAUNCHES
    got, _ = cm.restore(2)
    assert port_parity.LAUNCHES - launches == 1
    assert c.stats.counters["ckpt.stripe_reconstructed"] == 1
    assert np.array_equal(got["params.w"], t["params"]["w"].cpu().numpy())
    assert torch.equal(got["params.h"], t["params"]["h"].cpu())


def test_card_parity_equals_cpu_parity(cuda_device):
    """The parity objects written from the card equal those written with
    the plain version, byte for byte."""
    t = tensor_tree(6)
    (gc, _, gcm), (cc, _, ccm) = mk(device=cuda_device), mk()
    gcm.save(1, t)
    ccm.save(1, t)
    assert stored_objects(gc) == stored_objects(cc)
