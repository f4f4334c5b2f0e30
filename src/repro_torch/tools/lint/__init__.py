"""lustre-lint: protocol-discipline static analyzer.

Eight PRs of this repo accumulated unwritten protocol disciplines; this
package checks them mechanically on every CI run (`python -m
repro_torch.tools.lint src/`).  The rules (ids in parentheses):

  * ``txn-scope``      — mutating (transno-bearing) ``op_*``/``_reint_*``
    handlers must open an undo-scoped transaction (``self.txn`` /
    ``self.txn_meta`` / a FilterDevice mutator wired to ``txn_hook``).
  * ``emit-in-txn``    — every ``changelog.emit`` (or a forwarding
    wrapper like ``MdsTarget._cl``) must assign its record and retract
    it inside a registered transaction undo; llog catalog writes outside
    the llog/changelog implementation layer need the same scope.
  * ``fail-site``      — every ``OBD_FAIL`` checkpoint callsite
    (``maybe_fail``/``note``/``state.check``/``state.defer``) names a
    site registered in ``core/fail.py`` and every registered site has at
    least one callsite (no dead sites).
  * ``fail-sweep``     — the machine-readable site inventory
    (``fail_sites.json``) the crash sweep parametrizes over matches the
    registry + callsites exactly, so sweep coverage can never silently
    drift (regenerate with ``--write-inventory``).
  * ``replay-coverage``— every op name registered in a handler table is
    either reply-cache-covered (its handler returns a transno, so the
    reply-cache/replay protocol gives exactly-once) or appears in the
    replay-idempotence test matrix (``tests/replay_matrix.py``) with a
    stated mechanism.
  * ``rpc-under-lock`` — no RPC issued while a function holds a local
    DLM resource mid-transition (mutated ``res.granted``/``res.waiting``)
    unless the callsite carries a ``# lint: rpc-under-lock(reason)``
    annotation.

Suppression syntax (reviewed exceptions): ``# lint: ok(rule[,rule]: why)``
on the offending line, or on a ``def`` line to cover the whole function.
Known-issue deferrals live in ``baseline.json`` next to this package.
See ``src/repro/core/README.md`` for the full discipline documentation.
"""
from repro_torch.tools.lint.analyzer import (  # noqa: F401
    Finding, LintResult, run_lint, load_inventory, write_inventory,
    INVENTORY_PATH, BASELINE_PATH, RULES,
)
