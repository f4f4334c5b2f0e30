"""The port's XOR parity kernel against the JAX reference.

The same numpy int32 inputs go through `repro.kernels.parity` (the
Pallas kernel in interpret mode) and `repro_torch.kernels.parity` (on
CPU tensors: its plain version).  XOR is exact, so outputs must be
bit-identical.  The byte entry points `ops.parity_bytes` and
`ops.reconstruct_bytes` are held against the reference's, call after
call through the port's reused staging buffers.  The CUDA kernel itself
is held against the plain version on the card by `chip_smoke.py` and by
the `card` tests at the end, which need no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import LustreCluster  # noqa: E402
from repro_torch.core import sanitize as port_sanitize  # noqa: E402
from repro_torch.kernels import ops, parity, ref  # noqa: E402

try:                                     # the card tests need no JAX
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import parity as jpar
except ImportError:                      # pragma: no cover
    jnp = jops = jpar = None


@pytest.fixture
def pallas():
    if jpar is None:
        pytest.skip("needs jax for the reference kernel")
    return jpar


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
def test_xor_parity_and_reconstruct_match_reference(pallas, K, N, block):
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


def test_parity_bytes_unequal_tails_match_reference(pallas):
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
def test_parity_bytes_odd_sizes_match_reference(pallas, sizes):
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


def _both_match_reference(chunks, device="cpu"):
    """parity_bytes and, for every chunk, reconstruct_bytes equal the
    reference's on `chunks`."""
    n = max(len(c) for c in chunks)
    p = ops.parity_bytes(chunks, device=device)
    assert p == jops.parity_bytes(chunks) and len(p) == n
    pad = [c.ljust(n, b"\0") for c in chunks]
    for miss in range(len(chunks)):
        surv = pad[:miss] + pad[miss + 1:]
        back = ops.reconstruct_bytes(surv, p, len(chunks[miss]),
                                     device=device)
        assert back == jops.reconstruct_bytes(surv, p, len(chunks[miss]))
        assert back == chunks[miss]


def test_parity_bytes_reuses_its_buffers_long_then_short(pallas):
    """One process: long chunks, then shorter ones, then a single one,
    all through the same staging buffers.  A longer chunk of an earlier
    call must leave nothing in a later call's padding."""
    rng = np.random.default_rng(14)
    staging = ops._staging(torch.device("cpu"))
    calls = [[rng.bytes(70001), rng.bytes(65536), rng.bytes(69999)],
             [rng.bytes(301), rng.bytes(13), rng.bytes(299), rng.bytes(5)],
             [rng.bytes(4096), rng.bytes(4093)],
             [rng.bytes(17)],
             [rng.bytes(70001) for _ in range(5)],
             [rng.bytes(3), rng.bytes(1)]]
    seen = set()
    for chunks in calls:
        _both_match_reference(chunks)
        seen.add(staging.bufs["host_in"].data_ptr())
    # grown twice at most (first call, then the 5-row call), never shrunk
    assert len(seen) <= 2
    assert staging.bufs["host_in"].numel() >= 5 * 70016


@pytest.mark.parametrize("sizes", [
    (13, 7, 1), (17, 33, 5), (4099, 4097, 4098), (1, 15, 31),
    (6, 10, 14, 18), (65537, 65535, 3),
])
def test_parity_bytes_lengths_off_4_and_16_match_reference(pallas, sizes):
    rng = np.random.default_rng(sum(sizes) + len(sizes))
    _both_match_reference([rng.bytes(s) for s in sizes])


@pytest.mark.parametrize("where", [0, 1, 3])
def test_parity_bytes_empty_chunk_among_full_ones(pallas, where):
    rng = np.random.default_rng(where)
    chunks = [rng.bytes(4096) for _ in range(3)]
    chunks.insert(where, b"")
    _both_match_reference(chunks)


@pytest.mark.parametrize("K", range(1, 25))
def test_parity_bytes_any_row_count_matches_reference(pallas, K):
    rng = np.random.default_rng(100 + K)
    _both_match_reference([rng.bytes(1000 + 37 * i) for i in range(K)])


@pytest.mark.parametrize("K,N", [(3, 64), (17, 100), (24, 37)])
def test_reconstruct_reads_row_views_and_row_lists(pallas, K, N):
    """Survivors that are strided rows of a larger tensor, or a list of
    rows, give the reference's reconstruction (no concatenation)."""
    big = _rows(2 * K, N, K * N)
    x = big[::2]
    want = np.asarray(jpar.xor_parity(jnp.asarray(x), block=N,
                                      interpret=True))
    rec_ref = np.asarray(jpar.reconstruct(jnp.asarray(x[1:]),
                                          jnp.asarray(want), block=N,
                                          interpret=True))
    t = torch.from_numpy(big)[::2]
    p = parity.xor_parity(t)
    np.testing.assert_array_equal(p.numpy(), want)
    np.testing.assert_array_equal(parity.reconstruct(t[1:], p).numpy(),
                                  rec_ref)
    rows = [t[i] for i in range(1, K)]
    np.testing.assert_array_equal(parity.reconstruct(rows, p).numpy(),
                                  rec_ref)
    np.testing.assert_array_equal(rec_ref, x[0])


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


@pytest.mark.parametrize("K,N", [(17, 1), (17, 4096), (17, 262147),
                                 (24, 37), (24, 262144)])
def test_kernel_many_rows_on_card(cuda_device, K, N):
    """More rows than the kernel takes by value: one launch all the same."""
    blocks = torch.from_numpy(_rows(K, N, 3 * K + N)).to(cuda_device)
    launches = parity.LAUNCHES
    got = parity.xor_parity(blocks)
    torch.cuda.synchronize()
    assert parity.LAUNCHES == launches + 1
    assert torch.equal(got, ref.xor_parity_ref(blocks))
    rec = parity.reconstruct(blocks[1:], got)
    assert torch.equal(rec, blocks[0])


@pytest.mark.parametrize("K,N", [(4, 262144), (5, 4096), (16, 1024),
                                 (17, 4096), (24, 65536)])
def test_reconstruct_from_row_views_on_card(cuda_device, K, N):
    """Survivors that are every other row of a larger tensor, or a list
    of rows of it, are read in place by one launch."""
    big = torch.from_numpy(_rows(2 * K, N, K + 7 * N)).to(cuda_device)
    x = big[::2]
    p = parity.xor_parity(x)
    assert torch.equal(p, ref.xor_parity_ref(x))
    for miss in (0, K - 1):
        surv = [x[i] for i in range(K) if i != miss]
        launches = parity.LAUNCHES
        rec = parity.reconstruct(surv, p)
        assert parity.LAUNCHES == launches + 1
        torch.cuda.synchronize()
        assert torch.equal(rec, x[miss]), miss
    assert torch.equal(parity.reconstruct(x[1:], p), x[0])


@pytest.mark.parametrize("K,N", [(4, 262144), (17, 4097), (24, 1000)])
def test_misaligned_rows_on_card(cuda_device, K, N):
    """Rows off a 16-byte boundary take 4-byte lanes."""
    blocks = torch.from_numpy(_rows(K, N, 11 * K + N)).to(cuda_device)
    buf = torch.empty(K * N + 1, dtype=torch.int32, device=cuda_device)
    buf[1:].copy_(blocks.reshape(-1))
    shifted = buf[1:].view(K, N)
    want = ref.xor_parity_ref(blocks)
    assert torch.equal(parity.xor_parity(shifted), want)
    assert torch.equal(parity.reconstruct(shifted[1:], want), blocks[0])


def test_parity_bytes_on_card_matches_cpu(cuda_device):
    """The card's byte path (pinned staging reused call after call) gives
    the CPU path's bytes: long chunks, shorter ones, a single one, an
    empty one, and more rows than the kernel takes by value."""
    rng = np.random.default_rng(5)
    calls = [[rng.bytes(1 << 20) for _ in range(4)],
             [rng.bytes(1000), rng.bytes(13), rng.bytes(999)],
             [rng.bytes(77)],
             [rng.bytes(4096), b"", rng.bytes(4095)],
             [rng.bytes(5000 + i) for i in range(24)],
             [rng.bytes(1 << 20) for _ in range(5)]]
    for chunks in calls:
        launches = parity.LAUNCHES
        got = ops.parity_bytes(chunks, device=cuda_device)
        assert parity.LAUNCHES == launches + 1
        assert got == ops.parity_bytes(chunks, device="cpu")
        n = max(len(c) for c in chunks)
        pad = [c.ljust(n, b"\0") for c in chunks]
        assert ops.reconstruct_bytes(pad[1:], got, len(chunks[0]),
                                     device=cuda_device) == chunks[0]
