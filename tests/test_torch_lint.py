"""lustre-lint on the port: twins of tests/test_lint.py's seeded-violation
tests for every rule class and of its shipped-tree gates, run with the
port's copy of the analyzer (`repro_torch.tools.lint`) against trees
under `<tmp>/repro_torch/core/` and against `src/repro_torch`; and the
port's run held to the reference's.

`python -m repro_torch.tools.lint src/repro_torch` uses the inventory
and baseline beside the port's analyzer and the replay matrix at
`src/repro_torch/tests/replay_matrix.py`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.tools.lint import run_lint, write_inventory
from repro_torch.tools.lint.__main__ import main

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
PORT = SRC / "repro_torch"
INVENTORY = PORT / "tools" / "lint" / "fail_sites.json"


def seed(tmp_path: Path, source: str, name: str = "bad.py") -> Path:
    """Plant a module inside a scan-eligible repro_torch/core/ tree."""
    core = tmp_path / "repro_torch" / "core"
    core.mkdir(parents=True, exist_ok=True)
    (core / name).write_text(source)
    return tmp_path


def lint_tree(tree: Path, *, matrix=None, baseline=None, fresh_inventory=True):
    """The analyzer over a seeded tree with its own inventory (tests that
    want a stale one pass fresh_inventory=False)."""
    inv = tree / "fail_sites.json"
    if fresh_inventory:
        first = run_lint([tree], inventory_path=inv, matrix_path=matrix,
                         baseline_path=baseline)
        write_inventory(first.inventory, inv)
    return run_lint([tree], inventory_path=inv, matrix_path=matrix,
                    baseline_path=baseline)


def rules_of(res):
    return sorted({f.rule for f in res.failures})


# ------------------------------------------------------------ rule seeds

TXN_SCOPE_BAD = """
class MdsTarget:
    def op_evil_setattr(self, req):
        self.inodes[req.body["fid"]].mode = req.body["mode"]
        return R.Reply(data={"ok": True}, transno=9)
"""

EMIT_OUTSIDE_TXN = """
class MdsTarget:
    def op_evil_note(self, req):
        self.changelog.emit("CREATE", fid=req.body["fid"])
        return R.Reply(data={})
"""

EMIT_NO_RETRACT = """
class MdsTarget:
    def op_evil_note(self, req):
        rec = self.changelog.emit("CREATE", fid=req.body["fid"])
        transno = self.txn(lambda: None)
        rep = R.Reply(data={})
        rep.transno = transno
        return rep
"""

UNREGISTERED_FAIL_SITE = """
from repro_torch.core import fail as fail_mod

class OstTarget:
    def op_evil_write(self, req):
        fail_mod.maybe_fail("ost.bogus.checkpoint")
        return R.Reply(data={})
"""

DEAD_FAIL_SITE = """
def _register():
    register_site("ost.dead.site", "registered but never checked")
"""

UNCOVERED_REPLAY_OP = """
class MdsTarget:
    def __init__(self):
        self.ops = {}
        self.ops["mystery"] = self.op_mystery

    def op_mystery(self, req):
        self.counter += 1        # mutates state, no transno, no matrix
        return R.Reply(data={"n": self.counter})
"""

RPC_UNDER_LOCK = """
class LdlmNamespace:
    def op_evil_enqueue(self, req):
        res = self.resource(req.body["res"])
        res.granted.append(req.body["handle"])
        peer = self.imports[req.body["peer"]]
        peer.request("ldlm_notify", {"res": req.body["res"]})
        return R.Reply(data={})
"""


def test_seeded_txn_scope_violation(tmp_path):
    res = lint_tree(seed(tmp_path, TXN_SCOPE_BAD))
    assert "txn-scope" in rules_of(res)


def test_seeded_emit_outside_txn(tmp_path):
    res = lint_tree(seed(tmp_path, EMIT_OUTSIDE_TXN))
    assert "emit-in-txn" in rules_of(res)
    assert any("discards" in f.message for f in res.failures)


def test_seeded_emit_without_retract_undo(tmp_path):
    res = lint_tree(seed(tmp_path, EMIT_NO_RETRACT))
    assert "emit-in-txn" in rules_of(res)
    assert any("retract" in f.message for f in res.failures)


def test_seeded_unregistered_fail_site(tmp_path):
    res = lint_tree(seed(tmp_path, UNREGISTERED_FAIL_SITE))
    assert "fail-site" in rules_of(res)
    assert any("not registered" in f.message for f in res.failures)


def test_seeded_dead_fail_site(tmp_path):
    res = lint_tree(seed(tmp_path, DEAD_FAIL_SITE))
    assert any("dead site" in f.message for f in res.failures)


def test_seeded_unswept_site_stale_inventory(tmp_path):
    """A new fail site added without --write-inventory drifts out of the
    crash sweep; the fail-sweep rule catches exactly that."""
    tree = seed(tmp_path, """
from repro_torch.core import fail as fail_mod
register_site("ost.first.site", "v1")

class OstTarget:
    def op_x(self, req):
        fail_mod.maybe_fail("ost.first.site")
""")
    inv = tree / "fail_sites.json"
    first = run_lint([tree], inventory_path=inv)
    write_inventory(first.inventory, inv)
    # grow the tree: a second registered+checked site, inventory unchanged
    seed(tmp_path, """
from repro_torch.core import fail as fail_mod
register_site("ost.first.site", "v1")
register_site("ost.second.site", "added later")

class OstTarget:
    def op_x(self, req):
        fail_mod.maybe_fail("ost.first.site")
        fail_mod.maybe_fail("ost.second.site")
""")
    res = run_lint([tree], inventory_path=inv)
    assert "fail-sweep" in rules_of(res)
    assert any("unswept" in f.message for f in res.failures)


def test_missing_inventory_is_a_finding(tmp_path):
    res = lint_tree(seed(tmp_path, UNREGISTERED_FAIL_SITE.replace(
        "ost.bogus.checkpoint", "ost.x")), fresh_inventory=False)
    assert any(f.rule == "fail-sweep" and "no site inventory" in f.message
               for f in res.failures)


def test_seeded_uncovered_replay_op(tmp_path):
    res = lint_tree(seed(tmp_path, UNCOVERED_REPLAY_OP))
    assert "replay-coverage" in rules_of(res)


def test_replay_matrix_covers_seeded_op(tmp_path):
    matrix = tmp_path / "replay_matrix.py"
    matrix.write_text(
        "REPLAY_MATRIX = {'MdsTarget': {'mystery': 'idempotent: test'}}\n")
    res = lint_tree(seed(tmp_path, UNCOVERED_REPLAY_OP), matrix=matrix)
    assert "replay-coverage" not in rules_of(res)


def test_stale_matrix_entry_flagged(tmp_path):
    matrix = tmp_path / "replay_matrix.py"
    matrix.write_text(
        "REPLAY_MATRIX = {'MdsTarget': {'vanished_op': 'whatever'}}\n")
    res = lint_tree(seed(tmp_path, UNCOVERED_REPLAY_OP), matrix=matrix)
    assert any("stale entry" in f.message for f in res.failures)


def test_transno_bearing_op_needs_no_matrix_entry(tmp_path):
    covered = UNCOVERED_REPLAY_OP.replace(
        'return R.Reply(data={"n": self.counter})',
        'return R.Reply(data={"n": self.counter}, transno=self.txn(u))')
    res = lint_tree(seed(tmp_path, covered))
    assert "replay-coverage" not in rules_of(res)


def test_seeded_rpc_under_lock(tmp_path):
    res = lint_tree(seed(tmp_path, RPC_UNDER_LOCK))
    assert "rpc-under-lock" in rules_of(res)


def test_rpc_under_lock_annotation_clears(tmp_path):
    annotated = RPC_UNDER_LOCK.replace(
        'peer.request("ldlm_notify"',
        '# lint: rpc-under-lock(holder yields, cannot cycle)\n'
        '        peer.request("ldlm_notify"')
    res = lint_tree(seed(tmp_path, annotated))
    assert "rpc-under-lock" not in rules_of(res)


def test_suppression_comment_clears_finding(tmp_path):
    suppressed = TXN_SCOPE_BAD.replace(
        "return R.Reply(",
        "# lint: ok(txn-scope: test fixture)\n        return R.Reply(")
    res = lint_tree(seed(tmp_path, suppressed))
    assert "txn-scope" not in rules_of(res)
    assert res.suppressed >= 1


def test_baseline_file_downgrades_finding(tmp_path):
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"known_issues": [
        {"rule": "txn-scope", "path": "repro_torch/core/bad.py",
         "symbol": "MdsTarget.op_evil_setattr"}]}))
    res = lint_tree(seed(tmp_path, TXN_SCOPE_BAD), baseline=base)
    assert "txn-scope" not in rules_of(res)
    assert res.baselined >= 1


# ------------------------------------------------------- CLI + shipped tree

def test_cli_exit_codes(tmp_path):
    tree = seed(tmp_path, TXN_SCOPE_BAD)
    inv = tree / "fail_sites.json"
    base = tree / "baseline.json"
    base.write_text('{"known_issues": []}')
    argv = [str(tree), "--inventory", str(inv), "--baseline", str(base)]
    assert main(argv + ["--write-inventory"]) == 1      # seeded violation
    (tree / "repro_torch" / "core" / "bad.py").write_text("x = 1\n")
    assert main(argv + ["--write-inventory"]) == 0      # clean again


def test_shipped_tree_is_clean():
    """Zero unsuppressed findings over the port's tree with the committed
    inventory and matrix."""
    assert main([str(PORT)]) == 0


def test_inventory_matches_shipped_tree():
    """The committed fail_sites.json is exactly what the analyzer would
    regenerate from the port's tree."""
    assert run_lint([PORT]).inventory == json.loads(INVENTORY.read_text())


def test_inventory_flavors_and_sides():
    sites = json.loads(INVENTORY.read_text())["sites"]
    assert len(sites) >= 20
    assert sites["mds.txn"]["flavor"] == "deferred"
    assert sites["mds.commit.before"]["flavor"] == "immediate"
    assert sites["dlm.blocking_ast"]["flavor"] == "check"
    assert sites["osc.flush"]["side"] == "client"
    assert sites["ptlrpc.mds.request_in"]["side"] == "server"
    for name, info in sites.items():
        assert info["callsites"], f"site {name} has no callsites"
        assert all(c.startswith(("src/repro_torch/core/",
                                  "src/repro_torch/fsio/"))
                   for c in info["callsites"]), name


# ------------------------------------------------------ against the reference

def test_port_run_is_the_reference_run():
    """The port's tree and the reference's give the same findings (each
    in its own package) and the same inventory: the same sites, with the
    same flavors, sides and descriptions, checked in the same modules."""
    ref_lint = pytest.importorskip("repro.tools.lint")
    ref = ref_lint.run_lint([SRC])
    port = run_lint([PORT])
    assert [(f.rule, f.path.replace("src/repro/", "src/repro_torch/"),
             f.line, f.suppressed) for f in ref.findings] == [
        (f.rule, f.path, f.line, f.suppressed) for f in port.findings]
    assert port.suppressed == ref.suppressed == 1

    def files(inv):
        return {name: (i["desc"], i["flavor"], i["side"],
                       sorted({c.split("/")[-1].split(":")[0]
                               for c in i["callsites"]}))
                for name, i in inv["sites"].items()}
    assert files(port.inventory) == files(ref.inventory)


def test_cli_on_the_port_tree_exits_0():
    """`python -m repro_torch.tools.lint src/repro_torch`, as a user runs
    it: exit 0, with the reference's one suppressed finding."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.tools.lint",
                          "src/repro_torch"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1].endswith(
        "0 finding(s), 1 suppressed, 0 baselined")
