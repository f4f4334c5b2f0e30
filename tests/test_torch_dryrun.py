"""The port's cost counter, roofline, dry-run and report, held against
analytic counts and against the reference's tools.

* Twins of tests/test_shardings.py's cost-analyzer tests: a 128x256x512
  product counts 2*128*256*512 FLOPs; a loop of 4 products counts 4x,
  whole or cut to one trip; one device has no collective bytes; a known
  redistribute on a fake (2, 2) mesh counts its operand's bytes, and a
  sharded product only the device's own share; the dtype byte table.
* The count of the qwen3-4b smoke prefill and train steps (B=2, S=64,
  attn "ref") equals the reference `hlo_cost.analyze` of the same steps
  compiled on a (1, 1) mesh of Auto axes (ROADMAP R1), exactly.
* `roofline.model_flops` equals the reference's for all 33 cells.
* `dryrun.trace_cell` of a smoke config on a fake (2, 2) mesh gives a
  record with the reference's keys, whose prefill FLOPs equal the
  counter's on one device over 4 (the product work splits evenly), and
  `report` renders its tables from a results directory.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models.config import RunConfig as RefRunConfig  # noqa: E402
from repro.parallel import shardings as ref_sh  # noqa: E402
from repro.tools import hlo_cost as ref_hlo  # noqa: E402
from repro.tools import roofline as ref_roofline  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.config import SHAPES, RunConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tools import hlo_cost, hlo_top, report, roofline  # noqa: E402
from repro_torch.train import steps  # noqa: E402

# the reference record's keys (repro/launch/dryrun.py run_cell)
RECORD_KEYS = {"arch", "shape", "kind", "mesh", "n_chips", "lower_s",
               "compile_s", "memory", "xla_cost_analysis", "hlo_cost",
               "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "generated_code_bytes"}


def fake_mesh(shape=(2, 2)):
    from torch.distributed.device_mesh import init_device_mesh
    dryrun.fake_group(int(np.prod(shape)))
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


# ----------------------------------------------------- counter twins

def test_flops_counting_simple_matmul():
    a, b = torch.zeros(128, 256), torch.zeros(256, 512)
    _, rep = hlo_cost.count(torch.matmul, a, b)
    assert rep.flops == 2 * 128 * 256 * 512
    assert rep.flops_by_kind == {"dot": 2 * 128 * 256 * 512}


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
def test_flops_loop_multiplied_by_trip_count(cut):
    w = torch.zeros(4, 64, 64)

    def f(x):
        with L.loop("layers", 4) as trips:
            for i in range(trips):
                x = x @ w[i]
        return x

    _, rep = hlo_cost.count(f, torch.zeros(64, 64), cut_loops=cut)
    assert rep.flops == 4 * 2 * 64 * 64 * 64
    assert rep.n_while == (1 if cut else 0)
    assert rep.trip_counts == ({"layers": 4} if cut else {})


def test_cut_loop_multiplies_its_backward():
    w = torch.randn(4, 16, 16, requires_grad=True)

    def f(x):
        with L.loop("layers", 4) as trips:
            for i in range(trips):
                x = x @ w[i]
        x.sum().backward()

    x = torch.randn(8, 16, requires_grad=True)    # every trip alike
    _, whole = hlo_cost.count(f, x)
    _, cut = hlo_cost.count(f, x, cut_loops=True)
    # forward 4 products, backward 2 products a trip
    assert whole.flops == cut.flops == 3 * 4 * 2 * 8 * 16 * 16


def test_hlo_top_ranks_products_by_flops():
    a, b, c = torch.zeros(64, 32), torch.zeros(32, 16), torch.zeros(16, 128)
    ops = hlo_top.record(lambda: (a @ b) @ c)
    top = hlo_top.top_costs(ops, k=1)
    assert top["dots"] == [(2 * 64 * 16 * 128, 1, "aten.mm.default", 1,
                            (64, 128))]
    assert top["collectives"] == [] and len(top["traffic"]) == 1


def test_no_collective_bytes_on_one_device():
    _, rep = hlo_cost.count(lambda x: x * 2, torch.zeros(8, 8))
    assert rep.collective_bytes == 0 and rep.collectives == {}


def test_collective_bytes_of_a_redistribute_on_a_fake_mesh():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake_mesh()
    with FakeTensorMode():
        a = L.distribute(torch.empty(128, 256), mesh, ("data", None))
        b = L.distribute(torch.empty(256, 512), mesh, (None, "model"))
        y, rep = hlo_cost.count(torch.matmul, a, b)
        assert y.placements == (Shard(0), Shard(1))
        # each device: its (64, 256) rows times its (256, 256) columns
        assert rep.flops == 2 * 64 * 256 * 256
        assert rep.collective_bytes == 0
        _, rep = hlo_cost.count(
            lambda t: t.redistribute(mesh, (Replicate(), Shard(1))), y)
    # one all-gather over "data" of the device's (64, 256) f32 shard
    assert rep.collectives == {"all-gather": 64 * 256 * 4}
    assert rep.collective_bytes == 64 * 256 * 4


def test_shape_bytes_table():
    assert hlo_cost.shape_bytes((128, 256), torch.float32) == 128 * 256 * 4
    assert hlo_cost.shape_bytes((2, 2), torch.bfloat16) == 8
    assert hlo_cost.shape_bytes((4,), torch.float32) + \
        hlo_cost.shape_bytes((2,), torch.int32) == 24
    assert hlo_cost.shape_bytes((), torch.int64) == 8
    assert hlo_cost.DTYPE_BYTES[torch.bool] == 1


# ------------------------------------------- against the reference


def _ref_count(kind):
    cfg = ref_smoke("qwen3-4b")
    rc = RefRunConfig(seq_len=64, global_batch=2, kind=kind, attn_impl="ref")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ref_sh.set_ambient_mesh(mesh)
    try:
        bundle = ref_steps.build_step(cfg, rc, mesh)
        with mesh:
            compiled = bundle.lower().compile()
    finally:
        ref_sh.set_ambient_mesh(None)
    return ref_hlo.analyze(compiled.as_text())


@pytest.mark.parametrize("kind,want", [("prefill", 23_134_208),
                                       ("train", 100_663_296)])
def test_smoke_step_flops_equal_reference_hlo_cost(kind, want):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_smoke_config("qwen3-4b")
    rc = RunConfig(seq_len=64, global_batch=2, kind=kind, attn_impl="ref")
    with FakeTensorMode():
        gen = torch.Generator("cpu").manual_seed(0)
        params = L.tree_init(registry.param_defs(cfg), gen)
        batch = steps.make_batch(cfg, rc, gen, with_labels=kind == "train")
        args = ((params, adamw.init_state(params), batch)
                if kind == "train" else (params, batch))
        _, rep = hlo_cost.count(steps.build_step(cfg, rc, device="cpu"),
                                *args)
    assert rep.flops == want
    assert _ref_count(kind).flops == want


@pytest.mark.parametrize("arch,shape", list(cells.cells()))
def test_model_flops_equal_reference(arch, shape):
    over = cells.OVERRIDES.get((arch, shape), {})
    rc = dataclasses.replace(SHAPES[shape], **over)
    from repro.models.config import SHAPES as REF_SHAPES
    ref_rc = dataclasses.replace(REF_SHAPES[shape], **over)
    assert roofline.model_flops(get_config(arch), rc) == \
        ref_roofline.model_flops(ref_config(arch), ref_rc)


def test_roofline_uses_h100_denominators():
    from repro_torch.launch import mesh
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.LINK_BW,
            mesh.HBM_BYTES) == (989e12, 3.35e12, 450e9, 80e9)
    rep = hlo_cost.CostReport(flops=989e12, traffic_bytes=3.35e12 / 2,
                              collective_bytes=450e9 / 4)
    r = roofline.compute(rep, get_config("qwen3-4b"), SHAPES["train_4k"], 1)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 0.5, 0.25)
    assert r.dominant == "compute"


# ---------------------------------------------------- dry-run, report

@pytest.fixture(scope="module")
def smoke_records():
    mesh = fake_mesh()
    cfg = get_smoke_config("qwen3-4b")
    out = {}
    for kind in ("train", "prefill"):
        rc = RunConfig(seq_len=64, global_batch=4, kind=kind,
                       attn_impl="ref", num_microbatches=1)
        out[kind] = {"arch": "qwen3-4b", "shape": f"smoke_{kind}",
                     "kind": kind, "mesh": "16x16", "n_chips": 4,
                     **dryrun.trace_cell(cfg, rc, mesh)}
    return out


def test_trace_cell_gives_the_reference_record(smoke_records):
    for kind, rec in smoke_records.items():
        assert set(rec) == RECORD_KEYS
        assert set(rec["memory"]) == MEMORY_KEYS
        assert set(rec["hlo_cost"]) == set(hlo_cost.CostReport().as_dict())
        assert set(rec["roofline"]) == {
            f.name for f in dataclasses.fields(roofline.Roofline)}
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["memory"]["temp_bytes"] > 0
        assert rec["hlo_cost"]["collective_bytes"] > 0, kind
        json.dumps(rec)


@pytest.mark.parametrize("kind", ["prefill"])
def test_trace_cell_flops_are_one_device_share(smoke_records, kind):
    """Every product of the forward splits over batch ("data") and heads
    or features ("model"), so each of the 4 devices counts a quarter of
    the single-device FLOPs.  (Not so the train step: in the backward,
    DTensor's cost model gathers some small weights and repeats their
    products on both "model" devices, 12.5 % more at this size.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_smoke_config("qwen3-4b")
    rc = RunConfig(seq_len=64, global_batch=4, kind=kind, attn_impl="ref")
    with FakeTensorMode():
        gen = torch.Generator("cpu").manual_seed(0)
        params = L.tree_init(registry.param_defs(cfg), gen)
        batch = steps.make_batch(cfg, rc, gen, with_labels=kind == "train")
        args = ((params, adamw.init_state(params), batch)
                if kind == "train" else (params, batch))
        _, rep = hlo_cost.count(steps.build_step(cfg, rc, device="cpu"),
                                *args)
    assert smoke_records[kind]["hlo_cost"]["flops"] * 4 == rep.flops


def test_report_renders_from_a_results_directory(smoke_records, tmp_path):
    for kind, rec in smoke_records.items():
        (tmp_path / f"qwen3-4b_smoke_{kind}_1pod.json").write_text(
            json.dumps(rec))
    (tmp_path / "qwen3-4b_smoke_train_1pod_fsdp-off.json").write_text("{}")
    loaded = report.load(str(tmp_path))
    assert len(loaded) == 2
    table = report.roofline_table(loaded)
    assert table.count("| qwen3-4b | smoke_") == 2
    assert "| yes |" in table
    summary = report.dryrun_summary(loaded)
    assert "2/2 cells traced OK" in summary and "fit 80 GB" in summary
