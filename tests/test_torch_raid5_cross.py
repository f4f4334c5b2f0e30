"""The raid5 data path of the port as a whole, against the reference.

* The `raid5` section of BENCH_rpc.json, measured on the port
  (`repro_torch.tools.raid5_metrics`, parity on the CPU), equals the
  committed numbers field by field and the reference benchmark's own
  run exactly.

Client uuids are strings whose length the simulator's wire-size model
counts, so virtual times depend on how many clients the process made
before (`RpcClient._uuid_seq`, process-wide).  BENCH_rpc.json was
written by `benchmarks.run` after other benchmarks had made clients, so
its uuids carry two-digit numbers: the runs here start the sequences at
10 in both packages.  (From a fresh process the rebuild takes 0.011359 s
of virtual time against the committed 0.01136 s; all else is equal.)
* A client-level raid5 life cycle (write, clean read, degraded read with
  one OST dead, rebuild onto a spare through lctl, truncate) leaves the
  same stored bytes, counters and virtual time in both packages.
"""
import contextlib
import itertools
import json
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import LustreCluster as RefCluster  # noqa: E402
from repro.core import dlm as ref_dlm  # noqa: E402
from repro.core import llog as ref_llog  # noqa: E402
from repro.core import ptlrpc as ref_rpc  # noqa: E402
from repro.fsio import LustreClient as RefClient  # noqa: E402
from repro_torch.core import LustreCluster as PortCluster  # noqa: E402
from repro_torch.core import dlm as port_dlm  # noqa: E402
from repro_torch.core import llog as port_llog  # noqa: E402
from repro_torch.core import ptlrpc as port_rpc  # noqa: E402
from repro_torch.core import sanitize as port_sanitize  # noqa: E402
from repro_torch.core.bridge import object_bytes  # noqa: E402
from repro_torch.fsio import LustreClient as PortClient  # noqa: E402
from repro_torch.tools.raid5_metrics import raid5_metrics  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parents[1] / "BENCH_rpc.json"

REF = SimpleNamespace(Cluster=RefCluster, Client=RefClient, kw={},
                      mods=(ref_dlm, ref_llog, ref_rpc))
PORT = SimpleNamespace(Cluster=PortCluster, Client=PortClient,
                       kw={"device": "cpu"},
                       mods=(port_dlm, port_llog, port_rpc))


@contextlib.contextmanager
def fresh_ids(P, uuid_start):
    """Run with package P's process-wide id sequences started afresh."""
    dlm, llog, rpc = P.mods
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rpc.RpcClient, "_uuid_seq", itertools.count(uuid_start))
        mp.setattr(rpc, "_trace_seq", itertools.count(1))
        mp.setattr(dlm, "_handle_seq", itertools.count(1))
        mp.setattr(llog, "_cookie_seq", itertools.count(1))
        yield


@pytest.fixture(autouse=True)
def _port_sanitizer_guard():
    before = len(port_sanitize.state.violations)
    yield
    new = port_sanitize.state.violations[before:]
    assert not new, "port sanitizer violations:\n" + "\n".join(
        v.render() for v in new)


@pytest.fixture(scope="module")
def port_metrics():
    with fresh_ids(PORT, 10):
        return raid5_metrics(device="cpu")


@pytest.mark.parametrize("section,field", [
    (s, f) for s, fields in {
        "clean": ["identical", "vtime_s", "ost_read_rpcs"],
        "degraded": ["identical", "vtime_s", "ost_read_rpcs", "overhead_x",
                     "reconstructed_units"],
        "rebuild": ["files", "bytes", "layout_swaps", "vtime_s",
                    "throughput_MBps"],
        "throttle": ["baseline_p99_s", "tbf_p99_s", "fifo_p99_s",
                     "tbf_p99_ratio", "fifo_p99_ratio"],
    }.items() for f in fields])
def test_port_reproduces_committed_raid5_numbers(port_metrics, section,
                                                 field):
    want = json.loads(BENCH.read_text())["raid5"][section][field]
    assert port_metrics[section][field] == want


def test_port_raid5_numbers_equal_reference_run(port_metrics):
    from benchmarks.bench_parity import raid5_metrics as ref_raid5_metrics
    with fresh_ids(REF, 10):
        ref = ref_raid5_metrics()
    assert port_metrics == ref
    assert port_metrics["degraded"]["identical"] is True
    assert port_metrics["clean"]["ost_read_rpcs"] == 4
    assert port_metrics["degraded"]["ost_read_rpcs"] == 8
    assert port_metrics["degraded"]["reconstructed_units"] == 4
    assert port_metrics["rebuild"]["bytes"] == 262144
    assert port_metrics["rebuild"]["layout_swaps"] == 1
    assert port_metrics["throttle"]["tbf_p99_ratio"] == 1.0
    assert port_metrics["throttle"]["fifo_p99_ratio"] == 16.0


def _life_cycle(P, size, ssz):
    """Write, read clean, fail ost1, read degraded, rebuild, truncate."""
    data = np.random.default_rng(11).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    c = P.Cluster(osts=5, mdses=1, clients=3, spare_osts=1, **P.kw)
    fs = P.Client(c, 0).mount()
    fh = fs.creat("/f", stripe_count=4, stripe_size=ssz, pattern="raid5")
    fs.write(fh, data, offset=0)
    fs.close(fh)
    for t in c.ost_targets:
        t.commit()

    def cold_read(idx, length):
        r = P.Client(c, idx).mount()
        f = r.open("/f")
        got = r.read(f, length, offset=0)
        r.close(f)
        return got

    assert cold_read(1, size) == data
    c.fail_node("ost1")
    assert cold_read(2, size) == data
    rep = c.lctl("rebuild", "OST0001", c.spare_uuids[0])
    assert rep["rebuilt"] == 1 and rep["swapped"] == 1
    assert cold_read(1, size) == data
    cut = size // 2 + 12345                   # not stripe-aligned
    fs.truncate("/f", cut)
    assert fs.stat("/f")["size"] == cut
    assert cold_read(2, cut) == data[:cut]
    lsm = P.Client(c, 1).mount().open("/f").lsm    # the rebuilt layout
    assert "OST0001" not in [o["ost"] for o in lsm.objects]
    return {"objects": object_bytes(c, lsm),
            "counters": dict(c.stats.counters), "now": c.now}


def test_client_life_cycle_matches_reference():
    with fresh_ids(REF, 0):
        ref = _life_cycle(REF, 1 << 20, 64 << 10)
    with fresh_ids(PORT, 0):
        port = _life_cycle(PORT, 1 << 20, 64 << 10)
    assert port["objects"] == ref["objects"]
    assert port["counters"] == ref["counters"]
    assert port["now"] == ref["now"]
    assert port["counters"]["lov.rebuild_object"] == 1
    assert port["counters"]["lov.degraded_read"] >= 1
