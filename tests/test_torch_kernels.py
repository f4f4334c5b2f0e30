"""The port's XOR parity kernel against the JAX reference.

The same numpy int32 inputs go through `repro.kernels.parity` (the
Pallas kernel in interpret mode) and `repro_torch.kernels.parity` (on
CPU tensors: its plain version).  XOR is exact, so outputs must be
bit-identical.  The CUDA kernel itself is held against the plain version
on the card by `chip_smoke.py` and by the card-only test at the end.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import parity as jpar  # noqa: E402
from repro_torch.core import LustreCluster  # noqa: E402
from repro_torch.core import sanitize as port_sanitize  # noqa: E402
from repro_torch.kernels import ops, parity, ref  # noqa: E402


@pytest.fixture(autouse=True)
def _port_sanitizer_guard():
    before = len(port_sanitize.state.violations)
    yield
    new = port_sanitize.state.violations[before:]
    assert not new, "port sanitizer violations:\n" + "\n".join(
        v.render() for v in new)


def _rows(K, N, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, size=(K, N), dtype=np.int32)


@pytest.mark.parametrize("K,N,block", [
    (2, 1024, 256), (5, 4096, 4096), (9, 512, 128), (3, 8192, 1024),
    (3, 1000, 256), (4, 37, 64), (2, 513, 512), (5, 4100, 1024),
    (1, 1, 1), (1, 3, 4096), (1, 1000, 256), (4, 1, 4096), (3, 3, 4096),
])
def test_xor_parity_and_reconstruct_match_reference(K, N, block):
    rows = _rows(K, N, K * 7919 + N)
    want = np.asarray(jpar.xor_parity(jnp.asarray(rows),
                                      block=min(block, N), interpret=True))
    got = parity.xor_parity(torch.from_numpy(rows))
    assert got.dtype == torch.int32 and tuple(got.shape) == (N,)
    np.testing.assert_array_equal(got.numpy(), want)
    # every missing row is recovered, as the reference recovers it
    for miss in range(K):
        surv = np.concatenate([rows[:miss], rows[miss + 1:]], 0)
        rec_ref = np.asarray(jpar.reconstruct(
            jnp.asarray(surv), jnp.asarray(want), block=min(block, N),
            interpret=True))
        rec = parity.reconstruct(torch.from_numpy(surv), got)
        np.testing.assert_array_equal(rec.numpy(), rec_ref)
        np.testing.assert_array_equal(rec.numpy(), rows[miss])
        np.testing.assert_array_equal(
            ref.reconstruct_ref(torch.from_numpy(surv), got).numpy(),
            rows[miss])


def test_parity_bytes_unequal_tails_match_reference():
    rng = np.random.default_rng(7)
    chunks = [rng.bytes(1000), rng.bytes(737), rng.bytes(1024)]
    p = ops.parity_bytes(chunks, device="cpu")
    assert p == jops.parity_bytes(chunks)
    assert len(p) == 1024
    pad = [c.ljust(1024, b"\0") for c in chunks]
    back = ops.reconstruct_bytes(pad[1:], p, 1000, device="cpu")
    assert back == jops.reconstruct_bytes(pad[1:], p, 1000)
    assert back == pad[0][:1000]


@pytest.mark.parametrize("sizes", [
    (1, 1), (3, 7, 5), (255, 255, 255), (1023, 1, 509), (5,),
    (16, 17, 15), (4096, 4095, 1), (65536, 65536, 65536, 65535),
])
def test_parity_bytes_odd_sizes_match_reference(sizes):
    rng = np.random.default_rng(sum(sizes))
    chunks = [rng.bytes(s) for s in sizes]
    n = max(sizes)
    p = ops.parity_bytes(chunks, device="cpu")
    assert p == jops.parity_bytes(chunks)
    assert len(p) == n
    pad = [c.ljust(n, b"\0") for c in chunks]
    for miss in range(len(chunks)):
        surv = [pad[j] for j in range(len(chunks)) if j != miss]
        back = ops.reconstruct_bytes(surv, p, sizes[miss], device="cpu")
        assert back == jops.reconstruct_bytes(surv, p, sizes[miss])
        assert back == chunks[miss], sizes


def test_parity_bytes_of_nothing_raises():
    with pytest.raises(ValueError):
        ops.parity_bytes([], device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        ops.parity_bytes([b"abcd"], device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        LustreCluster(osts=3)                 # device="cuda" is the default
    with pytest.raises(RuntimeError, match="cuda"):
        LustreCluster(osts=3, device="cuda:0")


def test_wrapper_checks_and_routes_only_cpu_tensors_to_plain(monkeypatch):
    """Wrong types and shapes raise; a tensor that is not on the CPU
    never reaches the plain version."""
    with pytest.raises(TypeError):
        parity.xor_parity(torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        parity.xor_parity(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        parity.xor_parity(torch.zeros((0, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        parity.reconstruct(torch.zeros((2, 8), dtype=torch.int32),
                           torch.zeros(7, dtype=torch.int32))

    def plain_must_not_run(blocks):
        raise AssertionError("plain version reached for "
                             f"{blocks.device} tensor")
    monkeypatch.setattr(ref, "xor_parity_ref", plain_must_not_run)
    with pytest.raises(ValueError):
        parity.xor_parity(torch.zeros((2, 8), dtype=torch.int32,
                                      device="meta"))
    launches = parity.LAUNCHES
    with pytest.raises(AssertionError, match="plain version reached"):
        parity.xor_parity(torch.zeros((2, 8), dtype=torch.int32))
    assert parity.LAUNCHES == launches        # the CPU route launches nothing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("K,N", [(1, 1), (3, 37), (4, 262144),
                                 (5, 262145), (16, 4097)])
def test_kernel_matches_plain_on_card(cuda_device, K, N):
    blocks = torch.from_numpy(_rows(K, N, K + N)).to(cuda_device)
    launches = parity.LAUNCHES
    got = parity.xor_parity(blocks)
    torch.cuda.synchronize()
    assert parity.LAUNCHES == launches + 1
    assert torch.equal(got, ref.xor_parity_ref(blocks))
    # rows that do not start on a 16-byte boundary take the 4-byte path
    buf = torch.empty(K * N + 1, dtype=torch.int32, device=cuda_device)
    buf[1:].copy_(blocks.reshape(-1))
    shifted = buf[1:].view(K, N)
    assert torch.equal(parity.xor_parity(shifted), ref.xor_parity_ref(blocks))
