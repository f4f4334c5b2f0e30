"""Whole runs of the training cell on the CPU at a size the CPU holds:
the reference against the program, `correct` false with the step broken
underneath (a state left unchanged; half of the batch left out), and the
control reading apart from the program."""
import pytest

from chipbench import calibrate, testing
from chipbench.cell import load_cell
from chipbench.kinds import train as train_kind
from chipbench.testing import SEED, run

NAME = "phi35moe.train_4k"


_threads = pytest.fixture(autouse=True)(testing.few_threads)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return testing.small_checkout(tmp_path_factory.mktemp("bench"),
                                  cells=[NAME])


def test_reference_matches_the_program_and_the_run_is_correct(bench):
    """The training cell's small configuration computes in float32, so
    the plain reference's first steps agree with the Trainer's to
    rounding; the run reports its metric and its checks last."""
    out = run(bench, NAME)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
    got = calibrate.readings(load_cell(NAME, bench), SEED, False, "cpu", 0)
    for k, v in got["program"].items():
        assert v < 1e-4, (k, v)


def copy_tree(tree):
    return {k: copy_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


class Unchanged(train_kind.Job):
    """A step that returns its state unchanged."""

    def unit(self, i):
        real = self.tr.step_fn
        self.tr.step_fn = lambda p, o, b: (p, o, real(
            copy_tree(p), copy_tree(o), b)[2])
        try:
            return super().unit(i)
        finally:
            self.tr.step_fn = real


class LateHalfBatch(train_kind.HalfBatch):
    """Half of the batch left out only once the set-up's steps are done:
    a fault that the first steps cannot see."""

    def unit(self, i):
        if i < self.t["checked_steps"]:
            return train_kind.Job.unit(self, i)
        return super().unit(0 if i == self.t["checked_steps"] else i)


@pytest.mark.parametrize("job,number", [
    (Unchanged, "change_gap"), (train_kind.HalfBatch, "grad_gap"),
    (LateHalfBatch, "late_grad_gap")])
def test_a_broken_training_step_is_not_correct(bench, job, number):
    out = run(bench, NAME, job=lambda c: job(c, SEED, "cpu"))
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_the_control_reads_apart_from_the_program(bench):
    """The control (the reference's steps in float8) reads at least three
    times the program on one of the numbers compared."""
    cell = load_cell(NAME, bench)
    got = calibrate.readings(cell, SEED, True, "cpu", 0)
    assert any(got["control"][k] >= 3 * max(got["program"][k], 1e-12)
               for k in cell.limits if k in got["control"]), got
