"""The simulator modules the port copies from the reference: snapshot,
cobd, chaos, the global namespace, the changelog auditor and the cell
table.

* Twins of the reference's tests of these modules, run on the port's
  copies with clusters on the CPU: tests/test_chaos.py (the same 24
  seeds and three oracles, and the same hypothesis block),
  tests/test_namespace.py, the snapshot tests of tests/test_obd.py, the
  collaborative-cache test of tests/test_fsio.py, the auditor and mirror
  tests of tests/test_changelog.py, and test_cells_cover_40_assignments
  of tests/test_archs.py.
* One cross test per copied module: the same scenario in both packages,
  each with its process-wide id sequences started afresh (client uuids
  count on the wire, ROADMAP R6), gives equal results, counters, bytes
  and virtual time.
"""
import contextlib
import importlib
import itertools
import types

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # bare env: sampled fallback
    from _hyposhim import given, settings, strategies as st

pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import LustreCluster, sanitize  # noqa: E402
from repro_torch.core import chaos as chaos_mod  # noqa: E402
from repro_torch.core import cobd as cobd_mod  # noqa: E402
from repro_torch.core import obd as O  # noqa: E402
from repro_torch.core import ptlrpc as R  # noqa: E402
from repro_torch.core.mds import ROOT_FID  # noqa: E402
from repro_torch.core.snapshot import SnapDevice  # noqa: E402
from repro_torch.fsio import FsError, LustreClient  # noqa: E402
from repro_torch.fsio.namespace import (SETUID, Automounter,  # noqa: E402
                                        GlobalNamespace, make_mount_object)
from repro_torch.launch.cells import LONG_OK, cells  # noqa: E402
from repro_torch.tools.audit import (ChangelogAuditor,  # noqa: E402
                                     NamespaceMirror)

SERVERS = ("mds0", "mds1", "ost0", "ost1", "ost2")
N_SEEDED = 24                            # the reference's CI matrix


@pytest.fixture(autouse=True)
def _port_sanitizer_guard():
    before = len(sanitize.state.violations)
    yield
    new = sanitize.state.violations[before:]
    assert not new, "port sanitizer violations:\n" + "\n".join(
        v.render() for v in new)


def cluster(**kw):
    return LustreCluster(**kw, device="cpu")


# ------------------------------------------------ twins of test_chaos.py

def _mk():
    c = cluster(osts=3, mdses=2, clients=3, commit_interval=8)
    clients = [LustreClient(c, i).mount() for i in range(3)]
    return c, clients


def _step_factory(clients):
    """The reference's rotating workload: mkdir, create+write, rename,
    unlink, raid5 read and raid5 write, each tolerating ENOENT."""
    fs = clients[0]
    fs.mkdir("/a")
    fs.mkdir("/b")
    fh = fs.creat("/a/r5", stripe_count=2, stripe_size=256,
                  stripe_offset=0, pattern="raid5")
    fs.write(fh, bytes(range(1, 201)) * 2, offset=0)
    fs.close(fh)
    n = {"i": 0}

    def step():
        i = n["i"]
        n["i"] += 1
        fsx = clients[i % len(clients)]
        op = i % 6
        try:
            if op == 0:
                fsx.mkdir(f"/a/d{i}")
            elif op == 1:
                h = fsx.creat(f"/b/f{i}")
                fsx.write(h, b"x" * 512)
                fsx.close(h)
            elif op == 2:
                fsx.rename(f"/b/f{i - 1}", f"/a/m{i}")
            elif op == 3:
                fsx.unlink(f"/a/m{i - 1}")
            elif op == 4:
                h = fs.open("/a/r5")
                fs.read(h, 64, offset=0)
                fs.close(h)
            else:
                h = fs.open("/a/r5")
                fs.write(h, b"y" * 64, offset=64 * (i % 4))
                fs.close(h)
        except FsError:
            pass
    return step


def _run_schedule(seed: int, steps: int) -> None:
    with sanitize.forced():
        c, clients = _mk()
        aud = ChangelogAuditor(clients[0])
        step = _step_factory(clients)
        eng = chaos_mod.ChaosEngine(c, SERVERS)
        sched = chaos_mod.generate_schedule(
            seed, steps, [f.rpc.nid for f in clients], SERVERS)
        eng.run(sched, step)
        assert not eng.flapped and not c.sim.faults.drop_prob \
            and not c.sim.faults.partitions
        for i, fsx in enumerate(clients):           # nobody is stuck
            fsx.mkdir(f"/alive{seed}_{i}")
            assert f"alive{seed}_{i}" in fsx.readdir("/")
        aud.tail()                                  # mirror == truth
        report = aud.verify()
        assert report["ok"], (seed, report["mismatches"])
        keys = [(r["mdt"], r["idx"]) for r in aud.feed]
        assert len(keys) == len(set(keys)), (seed, keys)
        san = c.sim.sanitize.info()                 # sanitizer clean
        assert san["enabled"] and san["violations"] == 0, san


@pytest.mark.parametrize("seed", range(N_SEEDED))
def test_chaos_schedule_holds_oracles(seed):
    _run_schedule(seed, steps=12)


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=N_SEEDED, max_value=2**31 - 1))
def test_chaos_any_seed_holds_oracles(seed):
    _run_schedule(seed, steps=8)


def test_schedule_is_deterministic_and_ends_healed():
    a = chaos_mod.generate_schedule(7, 16, ["elan:client0"], SERVERS)
    b = chaos_mod.generate_schedule(7, 16, ["elan:client0"], SERVERS)
    assert a == b
    assert a[-1] == ("heal",)
    assert {ev[0] for ev in a} <= set(chaos_mod.EVENT_KINDS)


def test_flap_suppressed_by_fail_site():
    c, clients = _mk()
    eng = chaos_mod.ChaosEngine(c, SERVERS)
    c.lctl("set_param", "fail_loc", "net.flap", 1, "drop")
    eng.apply(("flap", "ost0"))
    assert not eng.flapped
    assert "elan:ost0" not in c.sim.faults.down_nids
    c.lctl("set_param", "fail_loc", "")
    eng.apply(("flap", "ost0"))
    assert eng.flapped == {"ost0"}
    eng.heal()
    assert not eng.flapped
    clients[0].mkdir("/post")


# -------------------------------------------- twins of test_namespace.py

def two_cells():
    """Two independent clusters = two AFS-style cells."""
    home = cluster(osts=2, mdses=1, clients=2, commit_interval=32)
    proj = cluster(osts=2, mdses=1, clients=1, commit_interval=32)
    fs_home = LustreClient(home).mount()
    fs_proj = LustreClient(proj).mount()
    fh = fs_proj.creat("/data.bin")
    fs_proj.write(fh, b"project fileset payload")
    fs_proj.close(fh)
    fs_proj.mkdir("/sub")
    fs_proj.creat("/sub/deep.txt")
    return home, proj, fs_home, fs_proj


def _gns(fs_home, proj):
    amd = Automounter()
    amd.register("fileset://proj@cell2",
                 lambda: LustreClient(proj, 0).mount())
    make_mount_object(fs_home, "/mnt/proj", "fileset://proj@cell2")
    return amd, GlobalNamespace(fs_home, amd)


def test_mount_object_traversal():
    home, proj, fs_home, fs_proj = two_cells()
    amd, gns = _gns(fs_home, proj)
    assert gns.read_file("/mnt/proj/data.bin") == b"project fileset payload"
    assert gns.stat("/mnt/proj/sub/deep.txt")["type"] == "file"
    assert amd.mounts == 1


def test_lookup_of_mount_object_does_not_mount():
    home, proj, fs_home, fs_proj = two_cells()
    amd, gns = _gns(fs_home, proj)
    assert gns.stat("/mnt/proj")["mode"] & SETUID
    assert amd.mounts == 0


def test_mount_object_is_ordinary_directory():
    home, proj, fs_home, fs_proj = two_cells()
    make_mount_object(fs_home, "/mnt/proj", "fileset://proj@cell2")
    assert fs_home.stat("/mnt")["nlink"] == 3
    assert "proj" in fs_home.readdir("/mnt")
    fs_home.unlink("/mnt/proj/mntinfo")
    fs_home.rmdir("/mnt/proj")
    assert not fs_home.exists("/mnt/proj")


def test_unknown_fileset_errors():
    home, proj, fs_home, _ = two_cells()
    amd = Automounter()
    make_mount_object(fs_home, "/mnt/ghost", "fileset://nope")
    gns = GlobalNamespace(fs_home, amd)
    with pytest.raises(Exception):
        gns.read_file("/mnt/ghost/x")


def test_automount_expiry_remounts():
    home, proj, fs_home, fs_proj = two_cells()
    amd, gns = _gns(fs_home, proj)
    gns.stat("/mnt/proj/data.bin")
    amd.expire("fileset://proj@cell2")
    gns.stat("/mnt/proj/data.bin")
    assert amd.mounts == 2


def test_procfs_tree():
    c = cluster(osts=2, mdses=1, clients=1, commit_interval=8)
    fs = LustreClient(c).mount()
    fh = fs.creat("/x", stripe_count=2)
    fs.write(fh, b"y" * 100)
    fs.close(fh)
    p = c.procfs()
    assert p["targets"]["OST0000"]["kind"] == "obdfilter"
    assert p["targets"]["OST0000"]["num_objects"] == 1
    assert p["targets"]["MDS0000"]["num_inodes"] == 2
    assert p["targets"]["MDS0000"]["last_transno"] > 0
    assert p["counters"]["rpc.ost.write"] >= 1


# -------------------------------------- twins of test_obd.py (snapshot)

def test_snapshot_cow_versions():
    bot = O.FilterDevice("bot")
    cur = SnapDevice("cur", bot, 0)
    oid = cur.create(0)["oid"]
    cur.write(0, oid, 0, b"v1-data-x")
    s1 = cur.snap_add("monday", time=1e9)
    cur.write(0, oid, 0, b"v2-data-y")
    s2 = cur.snap_add("tuesday", time=2e9)
    cur.write(0, oid, 0, b"v3-data-z")
    assert cur.read(0, oid, 0, 9) == b"v3-data-z"
    assert SnapDevice("a", bot, s1).read(0, oid, 0, 9) == b"v1-data-x"
    assert SnapDevice("b", bot, s2).read(0, oid, 0, 9) == b"v2-data-y"


def test_snapshot_readonly_enforced():
    bot = O.FilterDevice("bot")
    cur = SnapDevice("cur", bot, 0)
    oid = cur.create(0)["oid"]
    cur.write(0, oid, 0, b"x")
    ro = SnapDevice("ro", bot, cur.snap_add("s", time=1e9))
    with pytest.raises(O.ObdError):
        ro.write(0, oid, 0, b"nope")
    with pytest.raises(O.ObdError):
        ro.destroy(0, oid)


def test_snapshot_restore():
    bot = O.FilterDevice("bot")
    cur = SnapDevice("cur", bot, 0)
    oid = cur.create(0)["oid"]
    cur.write(0, oid, 0, b"original!")
    idx = cur.snap_add("keep", time=1e9)
    cur.write(0, oid, 0, b"clobbered")
    cur.snap_restore(idx)
    assert cur.read(0, oid, 0, 9) == b"original!"


# --------------------------------------- twin of test_fsio.py (the COBD)

def test_read_through_collaborative_cache():
    c = cluster(osts=4, mdses=2, clients=3, ost_failover=True,
                commit_interval=16)
    fs = LustreClient(c, 0).mount()
    fh = fs.creat("/hot.bin", stripe_count=1, stripe_offset=1)
    fs.write(fh, bytes(range(256)) * 32)
    fs.close(fh)
    cobd_mod.make_caching_node(c, "client1", c.ost_targets[1], "COBD-t")
    r = LustreClient(c, 2).mount()
    fh = r.open("/hot.bin")
    assert r.read(fh, 8192) == bytes(range(256)) * 32
    assert c.stats.counters.get("ost.referral", 0) >= 1
    assert c.stats.bytes.get("cobd.served", 0) >= 8192


# ------------------------------ twins of test_changelog.py (the auditor)

def test_audit_mirror_matches_ground_truth_across_mdts():
    c = cluster(osts=2, mdses=2, clients=1, commit_interval=32)
    fs = LustreClient(c).mount()
    aud = ChangelogAuditor(fs)
    fs.mkdir("/d1")
    fs.mkdir("/d2")
    assert fs.resolve("/d1")[0] == 1
    fh = fs.creat("/top")
    fs.write(fh, b"abc")
    fs.close(fh)
    fh = fs.creat("/d1/a")
    fs.write(fh, b"hello")
    fs.close(fh)
    fs.close(fs.creat("/d1/b"))
    fs.symlink("/d1/a", "/d2/lnk")
    fs.link("/d1/a", "/d2/a2")
    fs.rename("/top", "/d1/top2")
    fs.rename("/d1/b", "/d2/b")
    fs.unlink("/d2/b")
    assert aud.tail() >= 10
    report = aud.verify()
    assert report["ok"], report["mismatches"]
    assert report["entries"] >= 5
    times = [r["time"] for r in aud.feed]
    assert times == sorted(times)
    assert {r["mdt"] for r in aud.feed} == {0, 1}
    for t in c.mds_targets:
        assert t.changelog.info()["records"] == 0
    fs.unlink("/d1/a")
    fs.unlink("/d1/top2")
    fs.unlink("/d2/a2")
    fs.unlink("/d2/lnk")
    fs.rmdir("/d2")
    aud.tail()
    report = aud.verify()
    assert report["ok"], report["mismatches"]
    assert fs.readdir("/d1") == {}
    assert aud.mirror.skipped_remote >= 2


def test_audit_mirror_tracks_sizes_and_hardlinks():
    c = cluster(osts=2, mdses=1, clients=1, commit_interval=64)
    fs = LustreClient(c).mount()
    aud = ChangelogAuditor(fs)
    fh = fs.creat("/f")
    fs.write(fh, b"x" * 1234)
    fs.close(fh)
    fs.link("/f", "/g")
    fs.unlink("/f")
    aud.tail()
    assert aud.verify()["ok"]
    gfid = fs.resolve("/g")
    assert aud.mirror.nodes[gfid]["size"] == 1234
    fs.unlink("/g")
    aud.tail()
    assert gfid not in aud.mirror.nodes
    assert aud.verify()["ok"]


def test_audit_bootstrap_from_populated_namespace():
    c = cluster(osts=2, mdses=2, clients=1, commit_interval=32)
    fs = LustreClient(c).mount()
    fs.mkdir("/pre")
    fs.mkdir("/pre/sub")
    fh = fs.creat("/pre/a", stripe_count=2)
    fs.write(fh, b"12345")
    fs.close(fh)
    fs.link("/pre/a", "/pre/b")
    fs.symlink("/pre/a", "/pre/s")
    for t in c.mds_targets:
        assert t.changelog.info()["records"] == 0
    aud = ChangelogAuditor(fs, bootstrap=True)
    report = aud.verify()
    assert report["ok"], report["mismatches"]
    afid = fs.resolve("/pre/a")
    assert aud.mirror.nodes[afid]["size"] == 5
    assert aud.mirror.nodes[afid]["links"] == {
        (fs.resolve("/pre"), "a"), (fs.resolve("/pre"), "b")}
    fs.rename("/pre/a", "/pre/sub/a2")
    fs.unlink("/pre/b")
    fs.close(fs.creat("/pre/new"))
    aud.tail()
    report = aud.verify()
    assert report["ok"], report["mismatches"]
    assert afid in aud.mirror.nodes


def test_audit_bootstrap_scan_races_with_activity():
    c = cluster(osts=1, mdses=1, clients=1, commit_interval=32)
    fs = LustreClient(c).mount()
    fs.mkdir("/old")
    aud = ChangelogAuditor(fs)
    fs.mkdir("/raced")
    fs.close(fs.creat("/raced/f"))
    aud.bootstrap_scan()
    report = aud.verify()
    assert report["ok"], report["mismatches"]
    rfid = fs.resolve("/raced/f")
    assert aud.mirror.nodes[rfid]["links"] == {(fs.resolve("/raced"), "f")}


_PROP_VERBS = ["create", "mkdir", "rename", "link", "unlink", "tailclear"]


# derandomized: the reference's twin is flaky on one example (ROADMAP R7)
@settings(max_examples=10, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.sampled_from(_PROP_VERBS),
                          st.integers(0, 5), st.integers(0, 5)),
                min_size=4, max_size=28))
def test_property_random_ops_mirror_matches_and_bookmarks_monotonic(ops):
    c = cluster(osts=1, mdses=2, clients=1, commit_interval=16)
    fs = LustreClient(c).mount()
    aud = ChangelogAuditor(fs)
    fs.mkdir("/dA")
    fs.mkdir("/dB")
    dirs = ["", "/dA", "/dB"]
    names = [f"n{i}" for i in range(4)]
    last_bm = {i: 0 for i in aud.users}

    def bookmarks_monotonic():
        for i, t in enumerate(c.mds_targets):
            bm = t.changelog.users[aud.users[i]]
            assert bm >= last_bm[i], (i, bm, last_bm[i])
            last_bm[i] = bm

    for verb, i, j in ops:
        src = f"{dirs[i % 3]}/{names[i % 4]}"
        dst = f"{dirs[j % 3]}/{names[j % 4]}"
        try:
            if verb == "create":
                fs.close(fs.creat(src, stripe_count=1))
            elif verb == "mkdir":
                fs.mkdir(src)
            elif verb == "rename":
                fs.rename(src, dst)
            elif verb == "link":
                fs.link(src, dst)
            elif verb == "unlink":
                fs.unlink(src)
            else:
                aud.tail()
                bookmarks_monotonic()
        except (FsError, R.RpcError):
            pass
    aud.tail()
    bookmarks_monotonic()
    report = aud.verify()
    assert report["ok"], (ops, report["mismatches"])
    keys = [(r["mdt"], r["idx"]) for r in aud.feed]
    assert len(keys) == len(set(keys))


def test_mirror_standalone_displacing_rename():
    m = NamespaceMirror()
    m.apply({"type": "CREAT", "fid": (0, 2, 1), "pfid": ROOT_FID,
             "name": "a", "idx": 1, "time": 1.0})
    m.apply({"type": "CREAT", "fid": (0, 3, 1), "pfid": ROOT_FID,
             "name": "b", "idx": 2, "time": 2.0})
    m.apply({"type": "RENAME", "fid": (0, 2, 1), "pfid": ROOT_FID,
             "name": "b", "idx": 3, "time": 3.0,
             "extra": {"spfid": ROOT_FID, "sname": "a"}})
    assert m.children[ROOT_FID] == {"b": (0, 2, 1)}
    assert (0, 3, 1) not in m.nodes


# ------------------------------------------- twin of test_archs.py:166

def test_cells_cover_40_assignments():
    assert len(list(cells(include_skipped=True))) == 40
    skipped = 40 - len(list(cells()))
    assert skipped == len(ARCHS) - len(LONG_OK)
    for arch in ARCHS:
        assert get_config(arch).name == arch


# ------------------------------------------------------ against the reference

def _pkg(name: str):
    """The modules a cross scenario uses, from package `name`."""
    mod = (lambda m: importlib.import_module(f"{name}.{m}"))
    core = mod("core")
    kw = {"device": "cpu"} if name == "repro_torch" else {}
    return types.SimpleNamespace(
        cluster=lambda **k: core.LustreCluster(**k, **kw),
        client=mod("fsio").LustreClient, FsError=mod("fsio").FsError,
        obd=mod("core.obd"), snapshot=mod("core.snapshot"),
        cobd=mod("core.cobd"), chaos=mod("core.chaos"),
        namespace=mod("fsio.namespace"), audit=mod("tools.audit"),
        cells=mod("launch.cells"),
        ids=(mod("core.dlm"), mod("core.llog"), mod("core.ptlrpc")))


@contextlib.contextmanager
def fresh_ids(pkg):
    """The package's process-wide id sequences started afresh."""
    dlm, llog, rpc = pkg.ids
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rpc.RpcClient, "_uuid_seq", itertools.count(0))
        mp.setattr(rpc, "_trace_seq", itertools.count(1))
        mp.setattr(dlm, "_handle_seq", itertools.count(1))
        mp.setattr(llog, "_cookie_seq", itertools.count(1))
        yield


def both(scenario):
    """`scenario(pkg)` run in the reference and in the port; returns the
    two results."""
    pytest.importorskip("repro.core")
    out = []
    for name in ("repro", "repro_torch"):
        pkg = _pkg(name)
        with fresh_ids(pkg):
            out.append(scenario(pkg))
    return out


def _state(c) -> dict:
    return {"counters": dict(c.stats.counters), "bytes": dict(c.stats.bytes),
            "now": c.now}


def test_snapshot_same_as_reference():
    def scenario(p):
        bot = p.obd.FilterDevice("bot")
        cur = p.snapshot.SnapDevice("cur", bot, 0)
        oid = cur.create(0)["oid"]
        reads = []
        for i, day in enumerate(("mon", "tue", "wed")):
            cur.write(0, oid, 3 * i, f"{day}-data".encode())
            cur.snap_add(day, time=1e9 * (i + 1))
        cur.punch(0, oid, 7)
        for idx, _ in enumerate(cur.snap_list(), 1):
            reads.append(p.snapshot.SnapDevice("s", bot, idx).read(
                0, oid, 0, 16))
        cur.snap_del(2)
        cur.snap_restore(1)
        return {"reads": reads, "now": cur.read(0, oid, 0, 16),
                "list": cur.snap_list(), "attr": cur.getattr(0, oid),
                "statfs": cur.statfs(), "objects": cur.list_objects(0)}
    ref, port = both(scenario)
    assert port == ref


def test_cobd_same_as_reference():
    """COBD referrals: a hot file read by two peers through a caching
    node, then rewritten (the cache invalidated) and read again."""
    def scenario(p):
        c = p.cluster(osts=4, mdses=2, clients=3, ost_failover=True,
                      commit_interval=16)
        fs = p.client(c, 0).mount()
        fh = fs.creat("/hot.bin", stripe_count=1, stripe_offset=1)
        fs.write(fh, bytes(range(256)) * 64)
        fs.close(fh)
        cobd, _ = p.cobd.make_caching_node(c, "client1", c.ost_targets[1],
                                           "COBD-t")
        got = []
        for idx in (2, 0, 2):
            r = p.client(c, idx).mount()
            fh = r.open("/hot.bin")
            got.append(r.read(fh, 16384))
            r.close(fh)
            if idx == 0:
                fh = fs.open("/hot.bin")
                fs.write(fh, b"z" * 4096, offset=4096)
                fs.close(fh)
        return {"reads": got, "cached": cobd.used, **_state(c)}
    ref, port = both(scenario)
    assert port["counters"]["ost.referral"] >= 1
    assert port["bytes"]["cobd.served"] >= 16384
    assert port == ref


def test_chaos_same_as_reference():
    def scenario(p):
        c = p.cluster(osts=3, mdses=2, clients=3, commit_interval=8)
        clients = [p.client(c, i).mount() for i in range(3)]
        aud = p.audit.ChangelogAuditor(clients[0])
        fs = clients[0]
        fs.mkdir("/a")
        n = {"i": 0}

        def step():
            n["i"] += 1
            try:
                clients[n["i"] % 3].mkdir(f"/a/d{n['i']}")
            except p.FsError:
                pass
        eng = p.chaos.ChaosEngine(c, SERVERS)
        sched = p.chaos.generate_schedule(
            5, 12, [f.rpc.nid for f in clients], SERVERS)
        failed = eng.run(sched, step)
        aud.tail()
        return {"schedule": sched, "failed": failed,
                "entries": sorted(clients[1].readdir("/a")),
                "feed": aud.feed, "report": aud.verify(), **_state(c)}
    ref, port = both(scenario)
    assert port["report"]["ok"]
    assert port == ref


def test_namespace_same_as_reference():
    def scenario(p):
        home = p.cluster(osts=2, mdses=1, clients=2, commit_interval=32)
        proj = p.cluster(osts=2, mdses=1, clients=1, commit_interval=32)
        fs_home = p.client(home).mount()
        fs_proj = p.client(proj).mount()
        fh = fs_proj.creat("/data.bin")
        fs_proj.write(fh, b"project fileset payload")
        fs_proj.close(fh)
        amd = p.namespace.Automounter()
        amd.register("fileset://proj@cell2",
                     lambda: p.client(proj, 0).mount())
        p.namespace.make_mount_object(fs_home, "/mnt/proj",
                                      "fileset://proj@cell2")
        gns = p.namespace.GlobalNamespace(fs_home, amd)
        data = gns.read_file("/mnt/proj/data.bin")
        amd.expire("fileset://proj@cell2")
        st_ = gns.stat("/mnt/proj/data.bin")
        return {"data": data, "size": st_["size"], "mounts": amd.mounts,
                "ls": sorted(gns.readdir("/mnt/proj")),
                "home": _state(home), "proj": _state(proj)}
    ref, port = both(scenario)
    assert port == ref


def test_audit_same_as_reference():
    def scenario(p):
        c = p.cluster(osts=2, mdses=2, clients=1, commit_interval=32)
        fs = p.client(c).mount()
        fs.mkdir("/pre")
        fs.close(fs.creat("/pre/x"))
        aud = p.audit.ChangelogAuditor(fs, bootstrap=True)
        fs.mkdir("/d1")
        fh = fs.creat("/d1/a")
        fs.write(fh, b"hello")
        fs.close(fh)
        fs.link("/d1/a", "/pre/a2")
        fs.rename("/pre/x", "/d1/x2")
        fs.unlink("/d1/a")
        aud.tail()
        m = aud.mirror
        return {"feed": aud.feed, "report": aud.verify(),
                "nodes": m.nodes, "children": m.children,
                "skipped_remote": m.skipped_remote, **_state(c)}
    ref, port = both(scenario)
    assert port["report"]["ok"]
    assert port == ref


def test_cells_same_as_reference():
    def scenario(p):
        return {"all": list(p.cells.cells(include_skipped=True)),
                "run": list(p.cells.cells()), "skips": p.cells.cell_skips(),
                "overrides": p.cells.OVERRIDES, "long_ok": p.cells.LONG_OK}
    ref, port = both(scenario)
    assert port == ref
