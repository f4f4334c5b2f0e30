"""Whole runs of the prefill cells on the CPU at a size the CPU holds (the
chip check skipped, the kernels' plain versions standing in): the
reference against the program, a cell found by its files and entry
alone, `correct` false with an answer altered where it is produced, and
the control reading apart from the program."""
import json

import pytest
import torch

from chipbench import calibrate, testing
from chipbench.cell import load_cell
from chipbench.kinds import prefill as prefill_kind
from chipbench.testing import SEED, run

PREFILL = ["phi35moe.prefill_chat", "zamba2.prefill_docs"]


_threads = pytest.fixture(autouse=True)(testing.few_threads)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return testing.small_checkout(tmp_path_factory.mktemp("bench"),
                                  cells=PREFILL)


@pytest.mark.parametrize("name", PREFILL)
def test_reference_matches_the_program_in_float32(tmp_path, name):
    """In float32 the plain reference and the port's prefill step agree
    to rounding: every cache entry and the served token."""
    b = testing.small_checkout(tmp_path, cells=[name],
                               phi35moe=testing.F32, zamba2=testing.F32)
    assert run(b, name)["correct"]
    got = calibrate.readings(load_cell(name, b), SEED, False, "cpu", 0.3)
    assert got["program"]["gap"] == 0.0
    for k, v in got["program"].items():
        assert v < 1e-4, (k, v)


@pytest.mark.parametrize("name", PREFILL)
def test_a_run_is_correct_and_reports_its_metrics(bench, name):
    out = run(bench, name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = load_cell(name, bench)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell.limits)


def test_a_cell_added_as_files_and_an_entry_is_found(tmp_path):
    bench = testing.small_checkout(tmp_path, cells=PREFILL)
    spec = json.loads(bench.read_text())
    spec["workloads"].append({"name": "phi35moe.prefill_docs",
                              "config": "phi35moe", "traffic": "docs",
                              "chips": 1, "why": "a later cell"})
    bench.write_text(json.dumps(spec))
    home = bench.parent / "chipbench"
    (home / "limits" / "phi35moe.prefill_docs.json").write_text(
        (home / "limits" / "phi35moe.prefill_chat.json").read_text())
    out = run(bench, "phi35moe.prefill_docs")
    assert out["correct"] and load_cell(
        "phi35moe.prefill_docs", bench).traffic["lengths"]["dist"] == "choice"


class AlteredToken(prefill_kind.Job):
    """The served token altered where it is produced."""

    def _serve(self, i):
        tok, cache = super()._serve(i)
        return (tok + 1) % self.cfg["vocab_size"], cache


class AlteredCache(prefill_kind.Job):
    """The keys and values the step hands on altered where they are
    produced (noise of their mean size), in the layers and at the
    positions that `where(layers, positions)` slices."""

    @staticmethod
    def where(layers, positions):
        return slice(None), slice(None)

    def _serve(self, i):
        tok, cache = super()._serve(i)
        gen = torch.Generator().manual_seed(i)
        for key in ("k", "v"):
            c = cache[key].clone()
            ls, ps = self.where(c.shape[0], c.shape[2])
            part = c[ls, :, ps]
            c[ls, :, ps] = part + part.abs().mean() * torch.randn(
                part.shape, generator=gen).to(c.dtype)
            cache[key] = c
        return tok, cache


class AlteredLastLayers(AlteredCache):
    """Only the last half of the layers' keys and values altered."""

    @staticmethod
    def where(layers, positions):
        return slice(layers // 2, None), slice(None)


class AlteredLongKeys(AlteredCache):
    """Only positions past half of the longest prompt altered, in every
    layer: a fault that long prompts alone show."""

    @staticmethod
    def where(layers, positions):
        return slice(None), slice(256, None)


@pytest.mark.parametrize("name,job,number", [
    ("zamba2.prefill_docs", AlteredToken, "gap"),
    ("zamba2.prefill_docs", AlteredCache, "kv_err"),
    ("phi35moe.prefill_chat", AlteredCache, "kv_med"),
    ("phi35moe.prefill_chat", AlteredLastLayers, "kv_layer_med"),
    ("phi35moe.prefill_chat", AlteredLongKeys, "kv_tail_med")])
def test_an_altered_answer_is_not_correct(bench, name, job, number):
    out = run(bench, name, job=lambda c: job(c, SEED, "cpu"))
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


@pytest.mark.parametrize("name", PREFILL)
def test_a_run_checks_a_draw_over_all_it_finished(bench, name):
    """The caches a run keeps while it serves are those of
    `Job.sample(n)` once it has finished n requests, whatever n is."""
    job = prefill_kind.Job(load_cell(name, bench), SEED, "cpu")
    job.setup(warm=False)
    R = job.prompts.per_round
    for i in range(4 * R + 3):
        job.unit(i)
        if i + 1 in (1, R, 2 * R + 1, 4 * R + 3):
            assert sorted(job.kept) == job.sample(i + 1)
    assert {i // R for i in job.kept} != {0}


@pytest.mark.parametrize("name", PREFILL)
def test_the_control_reads_apart_from_the_program(bench, name):
    """The control (the reference in float8 in the program's place) reads
    at least three times the program on one of the numbers compared, at
    the CPU's size (`calibrate.readings`, as on the card)."""
    cell = load_cell(name, bench)
    got = calibrate.readings(cell, SEED, True, "cpu", 0.3)
    assert any(got["control"][k] >= 3 * max(got["program"][k], 1e-12)
               for k in cell.limits), got
