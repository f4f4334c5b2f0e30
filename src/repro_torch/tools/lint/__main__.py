"""CLI: ``python -m repro_torch.tools.lint src/ [options]``.

Exit status: 0 = clean (suppressed/baselined findings allowed),
1 = unsuppressed findings, 2 = usage error.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.tools.lint.analyzer import (
    BASELINE_PATH, INVENTORY_PATH, run_lint, write_inventory)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.lint",
        description="lustre-lint: protocol-discipline static analyzer")
    ap.add_argument("paths", nargs="+",
                    help="files/trees to scan (repro/core + repro/fsio)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--write-inventory", action="store_true",
                    help="regenerate the OBD_FAIL site inventory the "
                         "crash sweep parametrizes over, then re-check")
    ap.add_argument("--inventory", default=str(INVENTORY_PATH),
                    help="site inventory path (default: packaged)")
    ap.add_argument("--matrix", default=None,
                    help="replay-idempotence matrix "
                         "(default: <tree>/tests/replay_matrix.py)")
    ap.add_argument("--baseline", default=str(BASELINE_PATH),
                    help="known-issue baseline file")
    args = ap.parse_args(argv)

    res = run_lint(args.paths, inventory_path=args.inventory,
                   matrix_path=args.matrix, baseline_path=args.baseline)
    if args.write_inventory and res.inventory is not None:
        write_inventory(res.inventory, args.inventory)
        # re-run so fail-sweep findings reflect the fresh inventory
        res = run_lint(args.paths, inventory_path=args.inventory,
                       matrix_path=args.matrix, baseline_path=args.baseline)

    if args.json:
        import json
        print(json.dumps({
            "files_scanned": res.files_scanned,
            "failures": len(res.failures),
            "suppressed": res.suppressed,
            "baselined": res.baselined,
            "findings": [vars(f) for f in res.findings],
        }, indent=1))
    else:
        for f in res.findings:
            print(f.render())
        print(f"lustre-lint: {res.files_scanned} files, "
              f"{len(res.failures)} finding(s), "
              f"{res.suppressed} suppressed, {res.baselined} baselined")
    return 1 if res.failures else 0


if __name__ == "__main__":
    sys.exit(main())
