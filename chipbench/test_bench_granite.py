"""The `granite4h.prefill_rag` cell on the CPU at a size the CPU holds (one
period of the layer pattern at d = 64, prompts of 64 and 128 tokens): the
cell found by its files and entries alone, a run `correct`, the
benchmark's reference against the program in float32, altered answers
refused, the new readers silent without a trace, and the counts."""
import json

import pytest
import torch

from chipbench import cell as cell_mod
from chipbench import testing
from chipbench.archs import granitemoehybrid as arch
from chipbench.cell import load_cell
from chipbench.kinds import prefill_arch
from chipbench.testing import SEED, run

NAME = "granite4h.prefill_rag"
METRICS = ["device_idle.prefill", "mfu.prefill_rag",
           "ssd_roofline.prefill_rag", "flash_roofline.prefill_rag"]
PERIOD = ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
SMALL = {"hidden_size": 64, "num_hidden_layers": 10, "layer_types": PERIOD,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "attention_multiplier": 0.125, "num_local_experts": 8,
         "num_experts_per_tok": 3, "intermediate_size": 32,
         "shared_intermediate_size": 48, "mamba_n_heads": 8,
         "mamba_d_head": 16, "mamba_d_state": 16, "mamba_chunk_size": 32,
         "vocab_size": 256,
         # the embedding's std scaled as 1/sqrt(hidden_size) from the
         # file's 0.01 at 4096: the logits keep the published width's scale
         "init": [["embed", "normal", 0.08], ["conv_w", "normal", 0.5],
                  ["a_log", "log_uniform", 1.0, 16.0],
                  ["dt_bias", "dt_bias", 0.001, 0.1],
                  ["skip_d", "const", 1.0]]}

_threads = pytest.fixture(autouse=True)(testing.few_threads)


def checkout(dest, **extra):
    """A small checkout holding the cell, its traffic rewritten to rounds
    of 4 prompts of 64 and 128 tokens."""
    bench = testing.small_checkout(dest, cells=[NAME],
                                   granite4h_small={**SMALL, **extra})
    path = bench.parent / "chipbench" / "traffic" / "rag.json"
    t = json.loads(path.read_text())
    t.update(round=4, sample=2, lengths={"dist": "choice",
                                          "values": [64, 128]})
    path.write_text(json.dumps(t))
    return bench


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("bench"))


def test_the_cell_is_found_by_its_files_and_entries(bench):
    c = load_cell(NAME, bench)
    assert c.kind == "prefill_arch" and c.chips == 1
    assert c.config["model_type"] == "granitemoehybrid"
    assert {m["name"] for m in c.end_to_end} == {
        "ttft_p95_ms", "prefill_tokens_per_s", "setup_s"}
    assert [m["name"] for m in c.per_layer] == METRICS
    assert set(c.limits) == {"gap", "kv_med", "kv_layer_med",
                             "kv_tail_med", "kv_err", "state_med",
                             "state_head_med", "conv_med"}


def test_a_run_is_correct_and_reports_its_metrics(bench):
    out = run(bench, NAME)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"ttft_p95_ms", "prefill_tokens_per_s",
                                   "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


def test_units_count_the_kernel_launches(bench):
    """On the CPU neither kernel runs: each unit records 0 of each."""
    job = prefill_arch.Job(load_cell(NAME, bench), SEED, "cpu")
    job.setup(warm=False)
    u = job.unit(0)
    assert (u["ssd_launches"], u["flash_launches"]) == (0, 0)
    assert u["tokens"] in (64, 128)


def test_reference_matches_the_program_in_float32(tmp_path):
    """In float32 the benchmark's reference and the port's prefill step
    agree to rounding: every cache entry and the served token."""
    b = checkout(tmp_path, **testing.F32)
    assert run(b, NAME)["correct"]
    got = prefill_arch.readings(load_cell(NAME, b), SEED, False, "cpu",
                                rounds=3)
    assert got["program"]["gap"] == 0.0
    for k, v in got["program"].items():
        assert v < 1e-4, (k, v)


class AlteredToken(prefill_arch.Job):
    """The served token altered where it is produced."""

    def _serve(self, i):
        tok, cache = super()._serve(i)
        return (tok + 1) % self.cfg["vocab_size"], cache


class AlteredState(prefill_arch.Job):
    """Each Mamba2 layer's SSM state altered where it is produced (noise
    of its mean size)."""

    def _serve(self, i):
        tok, cache = super()._serve(i)
        st = cache["state"]
        gen = torch.Generator().manual_seed(i)
        cache["state"] = st + st.abs().mean() * torch.randn(
            st.shape, generator=gen)
        return tok, cache


class AlteredHead(prefill_arch.Job):
    """One head's SSM state altered in each Mamba2 layer (noise of the
    head's mean size), as a fault of the SSD in one head would."""

    def _serve(self, i):
        tok, cache = super()._serve(i)
        st = cache["state"].clone()
        gen = torch.Generator().manual_seed(i)
        head = st[:, :, 3]
        st[:, :, 3] = head + head.abs().mean() * torch.randn(
            head.shape, generator=gen)
        cache["state"] = st
        return tok, cache


class AlteredConv(prefill_arch.Job):
    """Each Mamba2 layer's conv window shifted by one position, as a
    window cut one token early would be."""

    def _serve(self, i):
        tok, cache = super()._serve(i)
        cache["conv"] = cache["conv"].roll(1, dims=-2)
        return tok, cache


@pytest.mark.parametrize("job,number", [(AlteredToken, "gap"),
                                        (AlteredState, "state_med"),
                                        (AlteredHead, "state_head_med"),
                                        (AlteredConv, "conv_med")])
def test_an_altered_answer_is_not_correct(bench, job, number):
    out = run(bench, NAME, job=lambda c: job(c, SEED, "cpu"))
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_the_control_reads_apart_from_the_program(bench):
    """The control (the reference in float8 in the program's place) reads
    at least three times the program on one of the numbers compared."""
    c = load_cell(NAME, bench)
    got = prefill_arch.readings(c, SEED, True, "cpu", rounds=3)
    assert any(got["control"][k] >= 3 * max(got["program"][k], 1e-12)
               for k in c.limits), got


@pytest.mark.parametrize("metric", METRICS)
def test_the_new_readers_read_nothing_without_a_trace(bench, metric):
    c = load_cell(NAME, bench)
    units = [{"tokens": 128, "ssd_launches": 9, "flash_launches": 1}]
    r = cell_mod.Run(c, units, 1.0, 1.0, None)
    assert cell_mod.reader(c, metric)(r) is None


def test_the_kernel_readers_need_every_launch(bench):
    """With a trace, the SSD and K3 shares read each launch's bound over
    the kernels' device time, and nothing when a request missed a launch
    or the trace misses one of a launch's kernels."""
    c = load_cell(NAME, bench)
    cfg = c.config
    units = [{"tokens": 128, "ssd_launches": 9, "flash_launches": 1}]
    ssd_dev = [(t, t + 50, "void (anonymous namespace)::ssd_%s<128>("
                           "(anonymous namespace)::SsdParams)" % k)
               for t, k in zip(range(0, 3600, 100),
                               ["prep", "states", "scan", "output"] * 9)]
    dev = ssd_dev + [(3600, 4100, "flash_fwd_wgmma<bf16>"),
                     (4100, 9000, "gemm")]
    read = lambda m, u, d=dev: cell_mod.reader(c, m)(cell_mod.Run(
        c, u, 1e-5, 1.0, {"device": d, "window_s": 1e-5, "busy_s": 9e-6}))
    ssd = read("ssd_roofline.prefill_rag", units)
    assert ssd == pytest.approx(
        100 * 9 * arch.ssd_bound_s(cfg, 128) / 1.8e-6)
    from chipbench import count
    assert read("flash_roofline.prefill_rag", units) == pytest.approx(
        100 * count.flash_bound_s(1, 4, 2, 128, 16) / 5e-7)
    short = [dict(units[0], ssd_launches=8, flash_launches=0)]
    assert read("ssd_roofline.prefill_rag", short) is None
    assert read("flash_roofline.prefill_rag", short) is None
    assert read("ssd_roofline.prefill_rag", units, dev[1:]) is None
    assert read("device_idle.prefill", units) == pytest.approx(10.0)


def test_active_parameters_by_hand():
    """8.39 G matrix-product parameters a token without the head, from the
    published keys: 36 Mamba2 mixers, 4 attention mixers, 40 routers,
    top-10 of 72 experts of 768 and the shared expert of 1536."""
    cfg = json.loads((testing.HERE / "configs" / "granite4h_small.json")
                     .read_text())
    mamba = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2
    moe = 4096 * 72 + 10 * 3 * 4096 * 768 + 3 * 4096 * 1536
    assert (mamba, attn, moe) == (102_236_160, 41_943_040, 113_541_120)
    assert arch.layer_params(cfg) == 36 * mamba + 4 * attn + 40 * moe \
        == 8_389_918_720
    assert arch.prefill_flops(cfg, 8192) == \
        2.0 * (8192 * 8_389_918_720 + 4096 * 100352)
    assert arch.layers_of(cfg, "mamba") == 36
    assert arch.attention_shape(cfg) == (32, 8, 128)
    assert arch.model_config(cfg).n_active_params == pytest.approx(
        arch.layer_params(cfg), rel=1e-3)
