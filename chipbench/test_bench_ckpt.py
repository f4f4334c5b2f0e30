"""Whole runs of the checkpoint cell on the CPU at a size the CPU holds:
a round trip through a lost OST's rebuild is correct, and `correct` is
false with a restored byte or a parity byte altered where it is
produced, and with the program's own int8 storage path (the control)."""
import numpy as np
import pytest
import torch

from chipbench import testing
from chipbench.cell import load_cell
from chipbench.kinds import ckpt as ckpt_kind
from chipbench.testing import SEED, run

NAME = "phi35moe.ckpt_rank"


_threads = pytest.fixture(autouse=True)(testing.few_threads)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return testing.small_checkout(tmp_path_factory.mktemp("bench"),
                                  cells=[NAME])


def test_a_round_trip_through_a_lost_ost_is_correct(bench):
    out = run(bench, NAME, seconds=0.1)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert set(out["metrics"]) == {"ckpt_GBps", "setup_s"}
    assert list(out)[-1] == "checks"


def test_traced_run_reports_its_layers(bench):
    out = run(bench, NAME, trace=True, seconds=0.1)
    assert out["correct"]
    assert {"save_GBps.ckpt", "restore_GBps.ckpt", "mfu.ckpt",
            "device_idle.ckpt"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(load_cell(NAME, bench).limits) == set(out["checks"])


class AlteredRestore(ckpt_kind.Job):
    """One restored byte altered where the restore produces it."""

    def restore(self):
        u = super().restore()
        step, flat = self.restores[-1]
        name = sorted(n for n in flat if n != "opt.step")[0]
        a = torch.from_numpy(np.array(flat[name]))
        a.view(torch.uint8).view(-1)[0] ^= 1
        flat[name] = a.numpy()
        return u


class AlteredParity(ckpt_kind.Job):
    """A parity file's bytes altered where the save produces them."""

    def save(self):
        real = self.mgr._parity_for

        def bad(fh, data):
            p = bytearray(real(fh, data))
            p[0] ^= 1
            return bytes(p)

        self.mgr._parity_for = bad
        try:
            return super().save()
        finally:
            self.mgr._parity_for = real


@pytest.mark.parametrize("job,number", [
    (lambda c: AlteredRestore(c, SEED, "cpu"), "restore_diff"),
    (lambda c: AlteredParity(c, SEED, "cpu"), "parity_diff"),
    (lambda c: ckpt_kind.Job(c, SEED, "cpu", quantize="int8"),
     "restore_diff")], ids=["restored byte", "parity byte", "int8 control"])
def test_a_broken_checkpoint_is_not_correct(bench, job, number):
    out = run(bench, NAME, job=job, seconds=0.1)
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]
