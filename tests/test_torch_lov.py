"""raid5/SNS striping in the port's LOV: twins of the raid5 tests of
tests/test_lov.py.

Each twin runs its scenario, with the reference test's assertions, on
the reference cluster (parity by the Pallas kernel in interpret mode)
and on the port's cluster (`device="cpu"`: the kernel's plain version),
then holds the two against each other exactly: every slot's stored
bytes (parity units included), every `stats.counters` entry and the
virtual clock.  These are simulator counts, so any difference is a
fault of the port.
"""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import LustreCluster as RefCluster  # noqa: E402
from repro.core import dlm as ref_dlm  # noqa: E402
from repro.core import llog as ref_llog  # noqa: E402
from repro.core import lov as ref_lov  # noqa: E402
from repro.core import ptlrpc as ref_rpc  # noqa: E402
from repro_torch.core import LustreCluster as PortCluster  # noqa: E402
from repro_torch.core import dlm as port_dlm  # noqa: E402
from repro_torch.core import llog as port_llog  # noqa: E402
from repro_torch.core import lov as port_lov  # noqa: E402
from repro_torch.core import ptlrpc as port_rpc  # noqa: E402
from repro_torch.core import sanitize as port_sanitize  # noqa: E402
from repro_torch.core.bridge import object_bytes  # noqa: E402

REF = SimpleNamespace(name="ref", Cluster=RefCluster, LV=ref_lov,
                      R=ref_rpc, kw={})
PORT = SimpleNamespace(name="port", Cluster=PortCluster, LV=port_lov,
                       R=port_rpc, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _port_sanitizer_guard():
    before = len(port_sanitize.state.violations)
    yield
    new = port_sanitize.state.violations[before:]
    assert not new, "port sanitizer violations:\n" + "\n".join(
        v.render() for v in new)


@pytest.fixture(autouse=True)
def _same_id_sequences(monkeypatch):
    """Start both packages' process-wide id sequences afresh.  Client
    uuids are strings whose length the wire-size model counts, so the
    virtual clock depends on how many clients the process made before;
    the twins compare clocks exactly."""
    for dlm, llog, rpc in ((ref_dlm, ref_llog, ref_rpc),
                           (port_dlm, port_llog, port_rpc)):
        monkeypatch.setattr(rpc.RpcClient, "_uuid_seq", itertools.count())
        monkeypatch.setattr(rpc, "_trace_seq", itertools.count(1))
        monkeypatch.setattr(dlm, "_handle_seq", itertools.count(1))
        monkeypatch.setattr(llog, "_cookie_seq", itertools.count(1))


def mk5(P, osts=3, spares=0, clients=2):
    c = P.Cluster(osts=osts, mdses=1, clients=clients, commit_interval=32,
                  spare_osts=spares, **P.kw)
    lov = c.make_lov(c.make_client_rpc(0))
    return c, lov


def _r5_payload(n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 256, n, dtype=np.uint8).tobytes()  # non-zero


def _fail_ost_of(c, uuid):
    c.fail_node("ost" + str(int(uuid[3:])))


def _state(c, lsms):
    return {"objects": [object_bytes(c, lsm) for lsm in lsms],
            "counters": dict(c.stats.counters),
            "now": c.now}


def _twin(scenario):
    """Run `scenario(P) -> (cluster, [lsm, ...])` on both packages and
    require identical stored bytes, counters and virtual time."""
    ref = _state(*scenario(REF))
    port = _state(*scenario(PORT))
    assert port["objects"] == ref["objects"]
    assert port["counters"] == ref["counters"]
    assert port["now"] == ref["now"]
    return port


@pytest.mark.parametrize("P", [REF, PORT], ids=lambda P: P.name)
def test_r5_parity_rotation_geometry(P):
    LV = P.LV
    lsm = LV.StripeMd(stripe_size=10, stripe_count=2, stripe_offset=0,
                      objects=[], pattern="raid5")
    assert [LV._r5_parity_slot(lsm, r) for r in range(6)] == \
        [2, 1, 0, 2, 1, 0]
    for r in range(6):
        p = LV._r5_parity_slot(lsm, r)
        slots = [LV._r5_slot(lsm, r, i) for i in range(2)]
        assert sorted(slots + [p]) == [0, 1, 2]


@pytest.mark.parametrize("P", [REF, PORT], ids=lambda P: P.name)
def test_r5_logical_size_witnesses(P):
    LV = P.LV
    lsm = LV.StripeMd(stripe_size=10, stripe_count=2, stripe_offset=0,
                      objects=[], pattern="raid5")
    assert LV._r5_logical_size(lsm, [15, 15, 10]) == 25
    assert LV._r5_logical_size(lsm, [0, 0, 10]) == 10
    assert LV._r5_logical_size(lsm, [0, 0, 0]) == 0
    assert LV._r5_logical_size(lsm, [None, 15, 10]) == 25


def test_raid5_round_trip_odd_size_and_rmw():
    def scenario(P):
        c, lov = mk5(P)
        lsm = lov.create(stripe_count=2, stripe_size=512, stripe_offset=0,
                         pattern="raid5")
        assert lsm.pattern == "raid5" and len(lsm.objects) == 3
        data = _r5_payload(5037)
        lov.write(lsm, 0, data)
        assert lov.read(lsm, 0, len(data)) == data
        assert lov.getattr(lsm)["size"] == len(data)
        patch = b"\xaa" * 700
        lov.write(lsm, 300, patch)
        want = data[:300] + patch + data[1000:]
        assert lov.read(lsm, 0, len(want)) == want
        assert lov.getattr(lsm)["size"] == len(want)
        return c, [lsm]
    st = _twin(scenario)
    assert st["counters"]["lov.parity_write"] == 2


def test_raid5_ea_round_trip_preserves_pattern():
    """An EA written by either package decodes in the other."""
    c_ref, lov_ref = mk5(REF)
    c_port, lov_port = mk5(PORT)
    made = {"ref": lov_ref.create(stripe_count=2, stripe_size=256,
                                  pattern="raid5"),
            "port": lov_port.create(stripe_count=2, stripe_size=256,
                                    pattern="raid5")}
    assert made["ref"].to_ea() == made["port"].to_ea()
    for lsm in made.values():
        for LV in (ref_lov, port_lov):
            back = LV.StripeMd.from_ea(lsm.to_ea())
            assert back.pattern == "raid5"
            assert back.objects == lsm.objects
            ea = lsm.to_ea()
            ea.pop("pattern", None)
            assert LV.StripeMd.from_ea(ea).pattern == "raid0"


def test_raid5_degraded_read_is_byte_identical():
    def scenario(P):
        c, lov = mk5(P)
        lsm = lov.create(stripe_count=2, stripe_size=512, stripe_offset=0,
                         pattern="raid5")
        data = _r5_payload(5037)
        lov.write(lsm, 0, data)
        for t in c.ost_targets:
            t.commit()
        _fail_ost_of(c, lsm.objects[1]["ost"])
        cold = c.make_lov(c.make_client_rpc(1))
        assert cold.read(lsm, 0, len(data)) == data
        assert c.stats.counters["lov.degraded_read"] >= 1
        assert c.stats.counters["lov.reconstruct_unit"] >= 1
        assert cold.getattr(lsm)["size"] == len(data)
        return c, [lsm]
    _twin(scenario)


def test_raid5_degraded_write_and_parity_update():
    def scenario(P):
        c, lov = mk5(P)
        lsm = lov.create(stripe_count=2, stripe_size=256, stripe_offset=0,
                         pattern="raid5")
        data = _r5_payload(2048, seed=3)
        lov.write(lsm, 0, data)
        for t in c.ost_targets:
            t.commit()
        _fail_ost_of(c, lsm.objects[0]["ost"])
        patch = _r5_payload(512, seed=4)
        lov.write(lsm, 0, patch)              # slot 0 dead: parity absorbs
        assert c.stats.counters["lov.degraded_write"] >= 1
        want = patch + data[512:]
        cold = c.make_lov(c.make_client_rpc(1))
        assert cold.read(lsm, 0, len(want)) == want
        return c, [lsm]
    _twin(scenario)


@pytest.mark.parametrize("P", [REF, PORT], ids=lambda P: P.name)
def test_raid5_second_failure_is_an_error_not_garbage(P):
    c, lov = mk5(P, osts=4)
    lsm = lov.create(stripe_count=3, stripe_size=256, stripe_offset=0,
                     pattern="raid5")
    lov.write(lsm, 0, _r5_payload(3000))
    c.fail_node("ost0")
    c.fail_node("ost1")
    with pytest.raises(P.R.RpcError):
        c.make_lov(c.make_client_rpc(1)).read(lsm, 0, 3000)


def test_raid5_rebuild_onto_spare_and_layout_swap():
    def scenario(P):
        c, lov = mk5(P, spares=1)
        lsm = lov.create(stripe_count=2, stripe_size=256, stripe_offset=0,
                         pattern="raid5")
        data = _r5_payload(3333, seed=7)
        lov.write(lsm, 0, data)
        for t in c.ost_targets:
            t.commit()
        dead = lsm.objects[1]["ost"]
        _fail_ost_of(c, dead)
        spare_uuid = c.spare_uuids[0]
        new = lov.rebuild_object(lsm, dead, lov.by_uuid[spare_uuid])
        assert new.objects[1]["ost"] == spare_uuid
        assert [o["ost"] for o in new.objects[::2]] == \
            [o["ost"] for o in lsm.objects[::2]]
        assert c.stats.counters["lov.rebuild_object"] == 1
        assert c.stats.counters["lov.rebuild_bytes"] > 0
        cold = c.make_lov(c.make_client_rpc(1))
        assert cold.read(new, 0, len(data)) == data
        _fail_ost_of(c, new.objects[0]["ost"])
        cold2 = c.make_lov(c.make_client_rpc(1))
        assert cold2.read(new, 0, len(data)) == data
        return c, [lsm, new]
    _twin(scenario)


def test_raid5_punch_recomputes_tail_parity():
    def scenario(P):
        c, lov = mk5(P)
        lsm = lov.create(stripe_count=2, stripe_size=256, stripe_offset=0,
                         pattern="raid5")
        data = _r5_payload(2048, seed=9)
        lov.write(lsm, 0, data)
        lov.punch(lsm, 700)                   # mid-unit truncate
        assert lov.getattr(lsm)["size"] == 700
        for t in c.ost_targets:
            t.commit()
        _fail_ost_of(c, lsm.objects[0]["ost"])
        cold = c.make_lov(c.make_client_rpc(1))
        assert cold.read(lsm, 0, 700) == data[:700]
        return c, [lsm]
    _twin(scenario)


def test_raid5_trailing_zero_caveat_is_kept():
    """Reconstruction pads a unit to its round's parity length, and the
    LOV strips trailing zero bytes off it, so real trailing zeros of a
    unit on a dead OST drop out of the degraded size.  The port keeps
    this caveat of the reference exactly: sizes, byte and RPC counts
    depend on it."""
    def scenario(P):
        c, lov = mk5(P)
        lsm = lov.create(stripe_count=2, stripe_size=256, stripe_offset=0,
                         pattern="raid5")
        data = _r5_payload(356, seed=5) + b"\0" * 50
        lov.write(lsm, 0, data)               # tail unit 1 ends in zeros
        for t in c.ost_targets:
            t.commit()
        _fail_ost_of(c, lsm.objects[1]["ost"])
        cold = c.make_lov(c.make_client_rpc(1))
        assert cold.getattr(lsm)["size"] == 356
        assert cold.read(lsm, 0, len(data)) == data
        return c, [lsm]
    _twin(scenario)


def test_raid1_resync_primary_side_stale():
    """RAID1 in the same LOV module: when the primary missed a write,
    resync copies b -> a (the stale side is the one recorded)."""
    def run(P):
        c = P.Cluster(osts=2, mdses=1, clients=2, commit_interval=4, **P.kw)
        a, b = c.make_oscs(c.make_client_rpc(0), writeback=False)
        r = P.LV.Raid1(a, b)
        oid = r.create()
        r.write(oid, 0, b"00000000")
        for t in c.ost_targets:
            t.commit()
        c.fail_node("ost0")                   # primary down
        r.write(oid, 0, b"11111111")          # only mirror B took it
        assert c.stats.counters["raid1.degraded_write"] == 1
        assert r.dirty_log[-1][3] == "a"
        c.restart_node("ost0")
        assert r.resync() == 1
        assert a.read(0, oid, 0, 8) == b"11111111"
        assert b.read(0, oid, 0, 8) == b"11111111"
        return dict(c.stats.counters), c.now
    assert run(PORT) == run(REF)
