"""Twins of tests/test_shardings.py's sharding half for the port, held
against the reference itself.

* `resolve_spec` gives the reference's PartitionSpec entries over a table
  and over a hypothesis property, on (2, 2), (16, 16) and (2, 16, 16).
* `layers.tree_specs` (fsdp on and off) equals the reference's leaf by
  leaf for every architecture of ARCHS at full width on both production
  meshes, and `cache_logical` equals the reference's per family.
* `placements` puts a ("pod", "data") dim on both mesh dims, pod first;
  `constrain` leaves plain tensors alone and redistributes DTensors.

The reference side uses its repeated-device Mesh (as its own test does);
the port side a DeviceMesh over a fake process group of the mesh's size.
"""
import jax
import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # bare env: sampled fallback
    from _hyposhim import given, settings, strategies as st
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.parallel import shardings as ref_sh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.dryrun import fake_group  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import rwkv6, transformer, zamba2  # noqa: E402
from repro_torch.parallel import shardings as sh  # noqa: E402

MESHES = {(2, 2): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


def ref_mesh(shape):
    n = int(np.prod(shape))
    devs = np.array(jax.devices()[:1] * n).reshape(shape)
    return Mesh(devs, MESHES[shape])


def port_mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    fake_group(int(np.prod(shape)))
    return init_device_mesh("cpu", shape, mesh_dim_names=MESHES[shape])


@pytest.fixture(scope="module", autouse=True)
def _no_ambient_mesh():
    yield
    ref_sh.set_ambient_mesh(None)
    sh.set_ambient_mesh(None)


TABLE = [
    (("batch", None), (4, 3)), (("batch", None), (3, 3)),
    ((None, "model"), (3, 4)), ((None, "model"), (3, 5)),
    ((None, "model", "model2"), (8, 3, 4)),
    ((None, "model", "model2"), (8, 4, 4)),
    ((None, "batch", "batch2", "model", "model2"), (36, 1, 524288, 8, 128)),
    ((None, "batch", "batch2", "model", "model2"), (36, 128, 32768, 8, 128)),
    ((None, "batch", "batch2", "model", "model2"), (40, 64, 4096, 16, 128)),
    (("model", None), (151936, 2560)), (("batch", None, "model"), (32, 1, 7)),
    (("batch", "model"), (512, 512)), (("batch", "batch"), (32, 32)),
]


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("logical,dims", TABLE)
def test_resolve_spec_equals_reference(shape, logical, dims):
    want = tuple(ref_sh.resolve_spec(ref_mesh(shape), logical, dims))
    assert sh.resolve_spec(port_mesh(shape), logical, dims) == want


@pytest.mark.parametrize("shape", list(MESHES))
def test_dp_axes_equal_reference(shape):
    assert sh.dp_axes(port_mesh(shape)) == ref_sh.dp_axes(ref_mesh(shape))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 64), min_size=1, max_size=4),
       st.lists(st.sampled_from(["batch", "model", "model2", "batch2",
                                 None]), min_size=1, max_size=4),
       st.sampled_from(sorted(MESHES)))
def test_resolve_spec_property_equals_reference(dims, logical, shape):
    n = min(len(dims), len(logical))
    dims, logical = [d * 16 if i % 2 else d for i, d in
                     enumerate(dims[:n])], logical[:n]
    want = tuple(ref_sh.resolve_spec(ref_mesh(shape), logical, dims))
    got = sh.resolve_spec(port_mesh(shape), logical, dims)
    assert got == want
    assert sum(1 for s in got if s == "model") <= 1


def _ref_specs(specs):
    leaves, _ = jax.tree_util.tree_flatten_with_path(specs)
    return {tuple(p.key for p in path): tuple(ns.spec)
            for path, ns in leaves}


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_specs_equal_reference_at_full_width(arch, shape, fsdp):
    want = _ref_specs(ref_layers.tree_specs(
        ref_registry.param_defs(ref_config(arch)), ref_mesh(shape), fsdp))
    got = dict(L.tree_items(L.tree_specs(
        registry.param_defs(get_config(arch)), port_mesh(shape), fsdp)))
    assert got == want


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b", "zamba2-7b"])
def test_cache_logical_equals_reference(arch):
    assert registry.cache_logical(get_config(arch)) == \
        ref_registry.cache_logical(ref_config(arch))


@pytest.mark.parametrize("mod,ref", [(transformer, "transformer"),
                                     (rwkv6, "rwkv6"), (zamba2, "zamba2")])
def test_family_cache_logical_equals_reference(mod, ref):
    from repro.models import rwkv6 as r_rwkv6
    from repro.models import transformer as r_tfm
    from repro.models import zamba2 as r_zamba2
    refs = {"transformer": r_tfm, "rwkv6": r_rwkv6, "zamba2": r_zamba2}
    assert mod.cache_logical() == refs[ref].cache_logical()


def test_placements_pod_and_data_shard_one_dim_in_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = port_mesh((2, 16, 16))
    spec = sh.resolve_spec(mesh, ("batch", None, "model"), (64, 3, 32))
    assert spec == (("pod", "data"), None, "model")
    assert sh.placements(mesh, spec) == (Shard(0), Shard(0), Shard(2))
    assert sh.placements(mesh, (None, None)) == (Replicate(),) * 3


def test_constrain_redistributes_dtensors_only():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    mesh = port_mesh((2, 2))
    x = torch.ones(4, 6)
    assert sh.constrain(x, ("batch", None)) is x          # no mesh
    with sh.ambient_mesh(mesh):
        assert sh.constrain(x, ("batch", None)) is x      # plain tensor
        with FakeTensorMode():
            d = L.distribute(torch.empty(4, 6), mesh, (None, None))
            got = sh.constrain(d, ("batch", "model"))
            assert got.placements == (Shard(0), Shard(1))
            assert sh.unshard(L.distribute(
                torch.empty(4, 6), mesh, ("data", "model"))).placements \
                == (Replicate(), Shard(1))
    assert sh.get_ambient_mesh() is None
