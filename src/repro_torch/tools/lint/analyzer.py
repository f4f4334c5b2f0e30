"""AST implementation of the lustre-lint protocol-discipline rules.

The analyzer is a plain two-phase pass: phase one walks every module
under ``repro/core`` + ``repro/fsio`` collecting facts (handler tables,
transno-bearing replies, fail-site callsites, emit sites, DLM state
mutations, RPC calls); phase two evaluates the rules over the collected
facts.  Everything is derived from the source — no imports of the
checked code — so the tool runs on a seeded/broken tree without
executing it.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path

RULES = ("txn-scope", "emit-in-txn", "fail-site", "fail-sweep",
         "replay-coverage", "rpc-under-lock")

_PKG_DIR = Path(__file__).resolve().parent
INVENTORY_PATH = _PKG_DIR / "fail_sites.json"
BASELINE_PATH = _PKG_DIR / "baseline.json"

# FilterDevice methods wired to txn_hook (ost.py: obd.txn_hook = self.txn):
# calling one of these from a handler opens the backend transaction.
OBD_MUTATORS = {"create", "destroy", "setattr", "write", "writev", "punch"}
# Changelog methods that open their own header transaction internally
# (Changelog is constructed with txn=self.txn).
CHANGELOG_TXN_METHODS = {"register", "deregister", "clear"}
# Modules that ARE the emit/llog implementation layer: the write
# primitives live here, txn scoping is their constructor contract
# (txn= hook), so the caller-side emit rule does not apply inside them.
EMIT_IMPL_MODULES = {"changelog.py", "llog.py", "fail.py"}
# svc_kind values an f-string fail site may expand over.
SVC_KINDS = ("mds", "ost")

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*ok\(([^):]*)")
_ANNOT_RE = re.compile(r"#\s*lint:\s*rpc-under-lock\(")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str          # repo-relative-ish display path
    line: int
    message: str
    symbol: str = ""   # enclosing Class.method, for baseline matching
    suppressed: bool = False
    baselined: bool = False

    def render(self) -> str:
        tag = " [suppressed]" if self.suppressed else (
            " [baselined]" if self.baselined else "")
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"


@dataclasses.dataclass
class LintResult:
    findings: list
    suppressed: int = 0
    baselined: int = 0
    files_scanned: int = 0
    inventory: dict | None = None    # generated site inventory

    @property
    def failures(self) -> list:
        return [f for f in self.findings
                if not f.suppressed and not f.baselined]


# ---------------------------------------------------------------- helpers

def _unparse(node) -> str:
    try:
        return ast.unparse(node)
    except Exception:               # pragma: no cover - defensive
        return ""


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _fstring_site(node) -> list[str] | None:
    """Expand an f-string fail-site argument over the known svc_kinds:
    ``f"{self.svc_kind}.txn"`` -> ["mds.txn", "ost.txn"].  Returns None
    when the argument is not a JoinedStr."""
    if not isinstance(node, ast.JoinedStr):
        return None
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            parts.append([str(v.value)])
        else:                        # a {expr}: expand over svc kinds
            parts.append(list(SVC_KINDS))
    out = [""]
    for p in parts:
        out = [o + x for o in out for x in p]
    return out


class _FuncFacts:
    """Everything rule evaluation needs to know about one function."""

    def __init__(self, cls: str, name: str, node: ast.FunctionDef):
        self.cls = cls
        self.name = name
        self.node = node
        self.symbol = f"{cls}.{name}" if cls else name
        self.lineno = node.lineno
        self.transno_exprs: list[tuple[int, ast.expr]] = []
        self.txn_open_lines: list[int] = []
        self.emit_calls: list[tuple[int, ast.Call, ast.stmt]] = []
        self.llog_add_calls: list[int] = []
        self.retracted_vars: set[str] = set()     # retract(x) inside nested defs
        self.rpc_calls: list[int] = []            # .request( callsites
        self.self_calls: list[tuple[int, str]] = []  # self.method() calls
        self.lock_mut_lines: list[int] = []       # res.granted/.waiting mutation
        self.mentions_replay = False
        self.returns_emit = False                 # forwarding emit wrapper


class _ModuleScan(ast.NodeVisitor):
    def __init__(self, path: Path, tree: ast.Module):
        self.path = path
        self.funcs: list[_FuncFacts] = []
        self.op_regs: list[tuple[str, int, str, str]] = []  # cls,line,op,handler
        self.aliases: list[tuple[str, str, str]] = []       # cls, new, old attr
        self.fail_sites_registered: list[tuple[int, str, str]] = []
        self.fail_callsites: list[tuple[int, str, object]] = []  # line,kind,arg
        self.class_svc_kind: dict[str, str] = {}
        self._cls_stack: list[str] = []
        self._fn_stack: list[_FuncFacts] = []
        self.visit(tree)

    # ------------------------------------------------------------ scoping
    @property
    def _cls(self) -> str:
        return self._cls_stack[-1] if self._cls_stack else ""

    @property
    def _fn(self) -> _FuncFacts | None:
        return self._fn_stack[-1] if self._fn_stack else None

    def visit_ClassDef(self, node: ast.ClassDef):
        self._cls_stack.append(node.name)
        self.generic_visit(node)
        self._cls_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef):
        if self._fn_stack:
            # nested function (an undo closure): stay attributed to the
            # enclosing handler but remember retract targets
            self.generic_visit(node)
            return
        ff = _FuncFacts(self._cls, node.name, node)
        self.funcs.append(ff)
        self._fn_stack.append(ff)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -------------------------------------------------------------- facts
    def visit_Assign(self, node: ast.Assign):
        fn = self._fn
        # handler-table registration: <ops-expr>["name"] = self.op_x
        for tgt in node.targets:
            if (isinstance(tgt, ast.Subscript)
                    and "ops" in _unparse(tgt.value).split(".")[-1:]):
                op = _const_str(tgt.slice)
                if op is not None:
                    handler = _unparse(node.value)
                    self.op_regs.append((self._cls, node.lineno, op, handler))
            # rep.transno = <expr> (a Reply being given a transno; bare
            # self.transno/req.transno bookkeeping is not a reply)
            if (isinstance(tgt, ast.Attribute) and tgt.attr == "transno"
                    and fn is not None
                    and not (isinstance(tgt.value, ast.Name)
                             and tgt.value.id in ("self", "req"))):
                fn.transno_exprs.append((node.lineno, node.value))
            # lock-state mutation by assignment: res.granted = [...]
            if isinstance(tgt, ast.Attribute) and tgt.attr in (
                    "granted", "waiting") and fn is not None:
                fn.lock_mut_lines.append(node.lineno)
        # emit assigned to a variable: clrec = self._cl(...) handled in
        # the rule pass via emit_calls carrying the statement node.
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        fn = self._fn
        func_src = _unparse(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else (
            node.func.id if isinstance(node.func, ast.Name) else "")

        # ---- fail-site registry + callsites
        if attr == "register_site" and node.args:
            name = _const_str(node.args[0])
            desc = _const_str(node.args[1]) if len(node.args) > 1 else ""
            if name:
                self.fail_sites_registered.append(
                    (node.lineno, name, desc or ""))
        if attr in ("maybe_fail", "note", "check", "defer") and node.args \
                and ("fail" in func_src or func_src.startswith("state.")):
            self.fail_callsites.append((node.lineno, attr, node.args[0]))

        if fn is not None:
            # ---- transno keyword on a Reply(...) construction
            if attr.endswith("Reply"):
                for kw in node.keywords:
                    if kw.arg == "transno" and not (
                            isinstance(kw.value, ast.Constant)
                            and kw.value.value == 0):
                        fn.transno_exprs.append((node.lineno, kw.value))
            # ---- txn-opening calls
            if attr in ("txn", "txn_meta") and func_src.startswith("self."):
                fn.txn_open_lines.append(node.lineno)
            if ".obd." in func_src and attr in OBD_MUTATORS:
                fn.txn_open_lines.append(node.lineno)
            if attr == "_wrap" and node.args:
                first = _unparse(node.args[0])
                if ".obd." in first and first.rsplit(".", 1)[-1] in \
                        OBD_MUTATORS:
                    fn.txn_open_lines.append(node.lineno)
            if ".changelog." in func_src and attr in CHANGELOG_TXN_METHODS:
                fn.txn_open_lines.append(node.lineno)
            # ---- emit / llog-write sites
            if attr == "emit" and "changelog" in func_src:
                fn.emit_calls.append((node.lineno, node, None))
            if attr == "add" and ("catalog" in func_src
                                  or "llog" in func_src):
                fn.llog_add_calls.append(node.lineno)
            if attr == "retract":
                for a in node.args:
                    if isinstance(a, ast.Name):
                        fn.retracted_vars.add(a.id)
            # ---- RPC + self-call + lock-mutation facts
            if attr == "request":
                fn.rpc_calls.append(node.lineno)
            if isinstance(node.func, ast.Attribute) and isinstance(
                    node.func.value, ast.Name) and \
                    node.func.value.id == "self":
                fn.self_calls.append((node.lineno, attr))
            if attr in ("append", "remove", "insert", "pop", "clear") and \
                    isinstance(node.func, ast.Attribute) and isinstance(
                        node.func.value, ast.Attribute) and \
                    node.func.value.attr in ("granted", "waiting"):
                fn.lock_mut_lines.append(node.lineno)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        fn = self._fn
        if fn is not None and node.attr == "replay":
            fn.mentions_replay = True
        self.generic_visit(node)

    # class attribute svc_kind = "..."
    def visit_Module(self, node):              # pragma: no cover - unused
        self.generic_visit(node)


def _scan_class_meta(scan: _ModuleScan, tree: ast.Module):
    scan.class_aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if not (isinstance(stmt, ast.Assign) and stmt.targets
                        and isinstance(stmt.targets[0], ast.Name)):
                    continue
                tname = stmt.targets[0].id
                if tname == "svc_kind":
                    v = _const_str(stmt.value)
                    if v:
                        scan.class_svc_kind[node.name] = v
                # class-level method alias: op_remote_create = op_remote_mkdir
                elif isinstance(stmt.value, ast.Name):
                    scan.class_aliases[(node.name, tname)] = stmt.value.id


# ---------------------------------------------------------------- comments

def _scan_comments(src: str):
    """Per-line suppressions and rpc-under-lock annotations.  A marker on
    a comment-only line (or block of them) also covers the next code
    line, so multi-line reason comments can precede the statement."""
    suppress: dict[int, set[str]] = {}
    annotate: set[int] = set()
    carry_sup: set[str] = set()
    carry_ann = False
    for i, line in enumerate(src.splitlines(), 1):
        m = _SUPPRESS_RE.search(line)
        rules = {r.strip() for r in m.group(1).split(",")
                 if r.strip()} if m else set()
        ann = bool(_ANNOT_RE.search(line))
        if rules:
            suppress.setdefault(i, set()).update(rules)
        if ann:
            annotate.add(i)
        stripped = line.strip()
        if stripped.startswith("#"):
            carry_sup |= rules
            carry_ann = carry_ann or ann
        elif stripped:
            if carry_sup:
                suppress.setdefault(i, set()).update(carry_sup)
            if carry_ann:
                annotate.add(i)
            carry_sup, carry_ann = set(), False
    return suppress, annotate


# ------------------------------------------------------------------ driver

class _FileCtx:
    def __init__(self, path: Path, display: str):
        self.path = path
        self.display = display
        src = path.read_text()
        self.tree = ast.parse(src)
        self.scan = _ModuleScan(path, self.tree)
        _scan_class_meta(self.scan, self.tree)
        self.suppress, self.annotate = _scan_comments(src)
        # map line -> enclosing top-level function (for def-line suppress)
        self.func_of_line: dict[int, _FuncFacts] = {}
        for ff in self.scan.funcs:
            end = getattr(ff.node, "end_lineno", ff.lineno)
            for ln in range(ff.lineno, end + 1):
                self.func_of_line[ln] = ff


def _collect_files(paths: list[Path]) -> list[Path]:
    out = []
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            out.append(p)
            continue
        for f in sorted(p.rglob("*.py")):
            posix = f.as_posix()
            if "repro_torch/core/" in posix or "repro_torch/fsio/" in posix:
                out.append(f)
    return out


def _display(path: Path) -> str:
    posix = path.as_posix()
    for marker in ("src/repro_torch/", "repro_torch/"):
        idx = posix.find(marker)
        if idx >= 0:
            return posix[idx:]
    return posix


class Linter:
    def __init__(self, paths: list[Path], *, inventory_path: Path,
                 matrix_path: Path | None, baseline_path: Path | None):
        self.files = [_FileCtx(p, _display(p))
                      for p in _collect_files(paths)]
        self.inventory_path = inventory_path
        self.matrix_path = matrix_path
        self.baseline = self._load_baseline(baseline_path)
        self.findings: list[Finding] = []
        self.inventory: dict = {}

    # -------------------------------------------------------------- infra
    @staticmethod
    def _load_baseline(path: Path | None) -> list[dict]:
        if path is None or not path.exists():
            return []
        data = json.loads(path.read_text())
        return data.get("known_issues", data if isinstance(data, list) else [])

    def _emit(self, ctx: _FileCtx, rule: str, line: int, msg: str,
              symbol: str = ""):
        f = Finding(rule, ctx.display, line, msg, symbol)
        sup = ctx.suppress.get(line, set())
        ff = ctx.func_of_line.get(line)
        if ff is not None:
            sup = sup | ctx.suppress.get(ff.lineno, set())
            if not symbol:
                f.symbol = ff.symbol
        if rule in sup or "all" in sup:
            f.suppressed = True
        elif any(b.get("rule") == rule
                 and ctx.display.endswith(b.get("path", "\x00"))
                 and (not b.get("symbol") or b["symbol"] == f.symbol)
                 for b in self.baseline):
            f.baselined = True
        self.findings.append(f)

    # --------------------------------------------------------------- run
    def run(self) -> LintResult:
        self.rule_txn_scope()
        self.rule_emit_in_txn()
        self.rule_fail_site()
        self.rule_replay_coverage()
        self.rule_rpc_under_lock()
        res = LintResult(findings=self.findings,
                         suppressed=sum(f.suppressed for f in self.findings),
                         baselined=sum(f.baselined for f in self.findings),
                         files_scanned=len(self.files),
                         inventory=self.inventory)
        return res

    # ----------------------------------------------------- rule: txn-scope
    HANDLER_RE = re.compile(r"^(op_|_reint_|_intent_)")

    @staticmethod
    def _delegated_transno(expr: ast.expr) -> bool:
        """A transno that came out of another call's result (peer reply,
        backend out["transno"], intent _transno) — the transaction was
        opened by the callee, not this handler."""
        if isinstance(expr, ast.Subscript):
            return True
        src = _unparse(expr)
        return src.startswith(("self.txn(", "self.txn_meta("))

    def rule_txn_scope(self):
        for ctx in self.files:
            for ff in ctx.scan.funcs:
                if not self.HANDLER_RE.match(ff.name):
                    continue
                if not ff.transno_exprs:
                    continue                     # read-only handler
                if ff.txn_open_lines:
                    continue                     # opened a txn scope
                bad = []
                for line, expr in ff.transno_exprs:
                    if self._delegated_transno(expr):
                        continue
                    if _unparse(expr) == "self.transno" and \
                            ff.mentions_replay:
                        continue                 # replay-idempotent return
                    bad.append((line, _unparse(expr)))
                for line, src in bad:
                    self._emit(ctx, "txn-scope", line,
                               f"handler {ff.symbol} returns "
                               f"transno={src} without opening a txn "
                               f"undo scope (self.txn/self.txn_meta/"
                               f"obd mutator)", ff.symbol)

    # --------------------------------------------------- rule: emit-in-txn
    def rule_emit_in_txn(self):
        # pass 1: find forwarding wrappers (return self.changelog.emit(..))
        forwarders: set[str] = set()
        for ctx in self.files:
            for ff in ctx.scan.funcs:
                for node in ast.walk(ff.node):
                    if isinstance(node, ast.Return) and isinstance(
                            node.value, ast.Call):
                        src = _unparse(node.value.func)
                        if src.endswith("changelog.emit"):
                            forwarders.add(ff.name)
                            ff.returns_emit = True
        # pass 2: check every emit site (direct or through a forwarder)
        for ctx in self.files:
            if ctx.path.name in EMIT_IMPL_MODULES:
                continue
            for ff in ctx.scan.funcs:
                for stmt in ast.walk(ff.node):
                    if not isinstance(stmt, (ast.Assign, ast.Expr,
                                             ast.Return)):
                        continue
                    call = stmt.value if isinstance(
                        getattr(stmt, "value", None), ast.Call) else None
                    if call is None:
                        continue
                    src = _unparse(call.func)
                    attr = src.rsplit(".", 1)[-1]
                    is_emit = (attr == "emit" and "changelog" in src) or \
                        (attr in forwarders and src.startswith("self."))
                    if not is_emit:
                        continue
                    line = call.lineno
                    if isinstance(stmt, ast.Return):
                        if ff.returns_emit:
                            continue             # the wrapper itself
                        self._emit(ctx, "emit-in-txn", line,
                                   f"{ff.symbol} returns a changelog "
                                   f"record it never retracts in a txn "
                                   f"undo", ff.symbol)
                        continue
                    if isinstance(stmt, ast.Expr):
                        self._emit(ctx, "emit-in-txn", line,
                                   f"{ff.symbol} discards the emitted "
                                   f"changelog record — an aborted txn "
                                   f"could not retract it", ff.symbol)
                        continue
                    tgt = stmt.targets[0]
                    var = tgt.id if isinstance(tgt, ast.Name) else None
                    if var is None or var not in ff.retracted_vars:
                        self._emit(ctx, "emit-in-txn", line,
                                   f"{ff.symbol} emits a changelog record "
                                   f"({var or _unparse(tgt)}) with no "
                                   f"changelog.retract({var or '...'}) in "
                                   f"a registered undo closure", ff.symbol)
                        continue
                    if not any(t >= line for t in ff.txn_open_lines):
                        self._emit(ctx, "emit-in-txn", line,
                                   f"{ff.symbol} emits a changelog record "
                                   f"but opens no transaction after the "
                                   f"emit (txn/txn_meta)", ff.symbol)
                # llog writes outside the implementation layer
                for line in ff.llog_add_calls:
                    if not ff.txn_open_lines:
                        self._emit(ctx, "emit-in-txn", line,
                                   f"{ff.symbol} appends an llog record "
                                   f"outside any transaction scope",
                                   ff.symbol)

    # ----------------------------------------------------- rule: fail-site
    def rule_fail_site(self):
        registry: dict[str, dict] = {}
        callsites: dict[str, list] = {}
        reg_ctx = None
        for ctx in self.files:
            for line, name, desc in ctx.scan.fail_sites_registered:
                registry[name] = {"desc": desc, "line": line,
                                  "file": ctx.display}
                reg_ctx = ctx
        for ctx in self.files:
            for line, kind, arg in ctx.scan.fail_callsites:
                lit = _const_str(arg)
                names = [lit] if lit is not None else _fstring_site(arg)
                if names is None:
                    continue                     # dynamic, not checkable
                matched = [n for n in names if n in registry]
                if lit is not None and not matched:
                    self._emit(ctx, "fail-site", line,
                               f"OBD_FAIL callsite {kind}({lit!r}) names "
                               f"a site not registered in core/fail.py")
                    continue
                if lit is None and not matched:
                    self._emit(ctx, "fail-site", line,
                               f"OBD_FAIL f-string callsite ({kind}) "
                               f"expands to no registered site: {names}")
                    continue
                for n in matched:
                    callsites.setdefault(n, []).append(
                        {"file": ctx.display, "line": line, "kind": kind})
        for name, info in sorted(registry.items()):
            if name not in callsites:
                ctx = reg_ctx or self.files[0]
                self._emit(ctx, "fail-site", info["line"],
                           f"registered OBD_FAIL site {name!r} has no "
                           f"checkpoint callsite (dead site)")
        # ---- the machine-readable inventory the crash sweep consumes
        flavor_rank = {"check": 3, "defer": 3, "note": 2, "maybe_fail": 1}
        flavor_name = {3: "check", 2: "deferred", 1: "immediate"}
        inv_sites = {}
        for name, info in sorted(registry.items()):
            calls = callsites.get(name, [])
            rank = max((flavor_rank[c["kind"]] for c in calls), default=1)
            client_side = any(
                c["file"].endswith(("osc.py", "mdc.py", "client.py"))
                for c in calls)
            inv_sites[name] = {
                "desc": info["desc"],
                "flavor": flavor_name[rank],
                "side": "client" if client_side else "server",
                "callsites": sorted(f"{c['file']}:{c['line']}"
                                    for c in calls),
            }
        self.inventory = {"format": 1, "tool": "repro_torch.tools.lint",
                          "sites": inv_sites}
        # ---- fail-sweep: committed inventory must match exactly
        ctx = reg_ctx or (self.files[0] if self.files else None)
        if ctx is None:
            return
        committed = load_inventory(self.inventory_path)
        if committed is None:
            self._emit(ctx, "fail-sweep", 1,
                       f"no site inventory at {self.inventory_path} — "
                       f"the crash sweep has nothing to parametrize "
                       f"over (run --write-inventory)")
            return
        have = set(committed.get("sites", {}))
        want = set(inv_sites)
        for name in sorted(want - have):
            self._emit(ctx, "fail-sweep", registry[name]["line"],
                       f"site {name!r} is registered but missing from "
                       f"the sweep inventory ({self.inventory_path.name})"
                       f" — unswept; run --write-inventory")
        for name in sorted(have - want):
            self._emit(ctx, "fail-sweep", 1,
                       f"inventory lists {name!r} which is no longer a "
                       f"registered site — stale; run --write-inventory")
        for name in sorted(want & have):
            if committed["sites"][name].get("flavor") != \
                    inv_sites[name]["flavor"]:
                self._emit(ctx, "fail-sweep", registry[name]["line"],
                           f"site {name!r} changed flavor "
                           f"({committed['sites'][name].get('flavor')} -> "
                           f"{inv_sites[name]['flavor']}); run "
                           f"--write-inventory")

    # ----------------------------------------- rule: replay-coverage
    def _load_matrix(self) -> dict | None:
        if self.matrix_path is None or not self.matrix_path.exists():
            return None
        ns: dict = {}
        exec(compile(self.matrix_path.read_text(),
                     str(self.matrix_path), "exec"), ns)
        return ns.get("REPLAY_MATRIX")

    def rule_replay_coverage(self):
        matrix = self._load_matrix()
        funcs_by_symbol = {}
        for ctx in self.files:
            for ff in ctx.scan.funcs:
                funcs_by_symbol[ff.symbol] = ff
        seen: set[tuple[str, str]] = set()
        for ctx in self.files:
            aliases = getattr(ctx.scan, "class_aliases", {})
            for cls, line, op, handler in ctx.scan.op_regs:
                seen.add((cls, op))
                m = re.match(r"self\.(\w+)$", handler)
                hname = m.group(1) if m else None
                for _ in range(4):           # resolve class-level aliases
                    if hname and (cls, hname) in aliases:
                        hname = aliases[(cls, hname)]
                ff = funcs_by_symbol.get(f"{cls}.{hname}") if hname else None
                covered = bool(ff and ff.transno_exprs)
                if covered:
                    continue                 # reply-cache-covered update op
                entry = (matrix or {}).get(cls, {}).get(op)
                if entry is None:
                    where = (f"{self.matrix_path}" if self.matrix_path
                             else "tests/replay_matrix.py")
                    self._emit(ctx, "replay-coverage", line,
                               f"op {op!r} ({cls}) bears no transno (not "
                               f"reply-cache-covered) and is missing from "
                               f"the replay-idempotence matrix ({where})",
                               f"{cls}.{op}")
        # stale matrix entries (op no longer registered) drift silently
        if matrix and self.files:
            ctx = self.files[0]
            for cls, ops in matrix.items():
                for op in ops:
                    if (cls, op) not in seen:
                        self._emit(ctx, "replay-coverage", 1,
                                   f"replay matrix lists {cls}.{op} which "
                                   f"is not registered in any handler "
                                   f"table (stale entry)", f"{cls}.{op}")

    # ------------------------------------------------- rule: rpc-under-lock
    def rule_rpc_under_lock(self):
        # per-class transitive closure of rpc-issuing methods
        rpc_methods: set[str] = set()
        by_cls: dict[str, list[_FuncFacts]] = {}
        for ctx in self.files:
            for ff in ctx.scan.funcs:
                by_cls.setdefault(ff.cls, []).append(ff)
                if ff.rpc_calls:
                    rpc_methods.add(ff.symbol)
        changed = True
        while changed:
            changed = False
            for cls, ffs in by_cls.items():
                for ff in ffs:
                    if ff.symbol in rpc_methods:
                        continue
                    if any(f"{cls}.{callee}" in rpc_methods
                           for _, callee in ff.self_calls):
                        rpc_methods.add(ff.symbol)
                        changed = True
        for ctx in self.files:
            for ff in ctx.scan.funcs:
                if not ff.lock_mut_lines:
                    continue
                first_mut = min(ff.lock_mut_lines)
                risky = [(ln, "request") for ln in ff.rpc_calls
                         if ln > first_mut]
                risky += [(ln, callee) for ln, callee in ff.self_calls
                          if ln > first_mut
                          and f"{ff.cls}.{callee}" in rpc_methods]
                for line, what in sorted(risky):
                    if line in ctx.annotate or ff.lineno in ctx.annotate:
                        continue
                    self._emit(ctx, "rpc-under-lock", line,
                               f"{ff.symbol} issues an RPC ({what}) while "
                               f"a local DLM resource is mid-transition "
                               f"(mutated at line {first_mut}); annotate "
                               f"with '# lint: rpc-under-lock(reason)' if "
                               f"the ordering is deadlock-safe", ff.symbol)


# -------------------------------------------------------------- inventory

def load_inventory(path: Path | str = INVENTORY_PATH) -> dict | None:
    path = Path(path)
    if not path.exists():
        return None
    return json.loads(path.read_text())


def write_inventory(inventory: dict, path: Path | str = INVENTORY_PATH):
    Path(path).write_text(json.dumps(inventory, indent=1, sort_keys=True)
                          + "\n")


# ------------------------------------------------------------------ entry

def run_lint(paths: list, *, inventory_path=INVENTORY_PATH,
             matrix_path=None, baseline_path=BASELINE_PATH) -> LintResult:
    paths = [Path(p) for p in paths]
    if matrix_path is None:
        # default: <repo>/tests/replay_matrix.py relative to the scanned
        # tree (src/.. or the tree root itself)
        for p in paths:
            for cand in (p.parent / "tests" / "replay_matrix.py",
                         p / "tests" / "replay_matrix.py"):
                if cand.exists():
                    matrix_path = cand
                    break
    linter = Linter(paths, inventory_path=Path(inventory_path),
                    matrix_path=Path(matrix_path) if matrix_path else None,
                    baseline_path=Path(baseline_path)
                    if baseline_path else None)
    return linter.run()
