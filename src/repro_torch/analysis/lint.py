"""AST-based concurrency/style linter for the port's tree — the port of
the JAX package's ``analysis/lint.py``, rule for rule.

A registered-rule framework over Python source files.  Two rule kinds:

* **file rules** (:data:`FILE_RULES`) see one parsed module at a time —
  lock discipline, blocking calls inside critical sections, frozen
  dataclasses, acquire-without-finally, raw placement literals.
* **project rules** (:data:`PROJECT_RULES`) see every module at once —
  cross-module properties like dead exports.

Suppression conventions (all line comments on the flagged line):

* ``# lint: ignore[rule-id]`` — suppress one rule on one line.
* ``# owner: <thread>`` — declares the single thread that owns a field
  mutation, satisfying ``lock-discipline`` without a lock.
* ``# lint: allow-mutable(reason)`` — a plan/placement dataclass that is
  deliberately mutated in place (``frozen-dataclass``).
* ``# lint: allow-dead(reason)`` — a public def kept despite no external
  reference (``dead-export``).

The rule ids, pragmas and :func:`lint_paths`' reference discovery are the
JAX linter's.  Two rules read the port's own terms: ``placement-literal``
the port's :data:`~repro_torch.core.placement.HW`/``SW``, and
``blocking-in-lock`` PyTorch's host/device syncs (``synchronize`` of a
stream, an event or ``torch.cuda``, ``.item()``, ``.tolist()``,
``.cpu()``) in place of JAX's ``device_put``/``block_until_ready``.

Entry point: :func:`lint_paths`; CLI: ``python -m repro_torch.analysis
lint``.
"""
from __future__ import annotations

import ast
import os
from typing import Callable, Iterable, Optional, Sequence

from ..core.placement import HW, SW

from .diagnostics import Diagnostic

__all__ = ["lint_paths", "lint_file", "FILE_RULES", "PROJECT_RULES",
           "LINT_RULES", "file_rule", "project_rule"]


class LintContext:
    """One parsed source file, with raw lines for pragma checks."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


FileRule = Callable[[LintContext], Iterable[Diagnostic]]
ProjectRule = Callable[[Sequence[LintContext], Sequence[LintContext]],
                       Iterable[Diagnostic]]

FILE_RULES: dict[str, FileRule] = {}
PROJECT_RULES: dict[str, ProjectRule] = {}


def file_rule(rule_id: str) -> Callable[[FileRule], FileRule]:
    def deco(fn: FileRule) -> FileRule:
        FILE_RULES[rule_id] = fn
        return fn
    return deco


def project_rule(rule_id: str) -> Callable[[ProjectRule], ProjectRule]:
    def deco(fn: ProjectRule) -> ProjectRule:
        PROJECT_RULES[rule_id] = fn
        return fn
    return deco


def _dotted(node: ast.AST) -> Optional[str]:
    """``self._lock`` / ``g.lock`` → dotted string; None for non-name chains."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_self_lockish(expr: ast.AST) -> Optional[str]:
    """``self.<attr>`` where attr smells like a lock/condition → attr."""
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name) and expr.value.id == "self"
            and ("lock" in expr.attr.lower() or "cond" in expr.attr.lower())):
        return expr.attr
    return None


def _self_field_of_target(t: ast.AST) -> Optional[str]:
    """Root ``self.<field>`` of an assignment target (attribute chains and
    subscripts included: ``self.x``, ``self.x.y``, ``self.x[i]``)."""
    while isinstance(t, (ast.Subscript, ast.Attribute)):
        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self"):
            return t.attr
        t = t.value
    return None


def _docstring_constants(tree: ast.Module) -> set[int]:
    """Line numbers of docstring Constant nodes (exempt everywhere)."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                out.add(id(body[0].value))
    return out


# --------------------------------------------------------------------------- #
# placement-literal — migrated from tests/test_placement.py
# --------------------------------------------------------------------------- #
@file_rule("placement-literal")
def _rule_placement_literal(ctx: LintContext) -> Iterable[Diagnostic]:
    """Raw placement-kind string literals outside the parser module.

    Every layer must go through :class:`repro_torch.core.placement.Placement`
    (``.parse`` / ``.is_hw`` / the module constants) instead of comparing
    raw strings — placement.py is the single module allowed to spell them.
    """
    if ctx.path.replace(os.sep, "/").endswith("core/placement.py"):
        return []
    doc_ids = _docstring_constants(ctx.tree)
    out = []
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Constant) and node.value in (HW, SW)
                and id(node) not in doc_ids):
            out.append(Diagnostic(
                rule="placement-literal", path=ctx.path, line=node.lineno,
                message=f"raw placement literal {node.value!r}",
                hint="use repro_torch.core.placement constants / "
                     "Placement.parse"))
    return out


# --------------------------------------------------------------------------- #
# lock-discipline — guarded fields mutated only under their lock / owner
# --------------------------------------------------------------------------- #
class _ClassLockScan(ast.NodeVisitor):
    """Per-method record of self-field mutations and their lock context."""

    def __init__(self) -> None:
        # (field, method, lineno, lock_depth>0)
        self.mutations: list[tuple[str, str, int, bool]] = []
        self._method = ""
        self._lock_depth = 0

    def scan_method(self, fn: ast.AST, name: str) -> None:
        self._method = name
        self.visit(fn)

    def visit_With(self, node: ast.With) -> None:
        lockish = any(_is_self_lockish(item.context_expr)
                      for item in node.items)
        if lockish:
            self._lock_depth += 1
        self.generic_visit(node)
        if lockish:
            self._lock_depth -= 1

    def _record(self, target: ast.AST, lineno: int) -> None:
        field = _self_field_of_target(target)
        if field is not None:
            self.mutations.append((field, self._method, lineno,
                                   self._lock_depth > 0))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Tuple):
                for el in t.elts:
                    self._record(el, node.lineno)
            else:
                self._record(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record(node.target, node.lineno)
        self.generic_visit(node)


@file_rule("lock-discipline")
def _rule_lock_discipline(ctx: LintContext) -> Iterable[Diagnostic]:
    """A field ever mutated under ``with self.<lock>:`` is *guarded*: every
    other mutation of it must also hold the lock, or carry an ``# owner:``
    comment naming the single thread that owns it.  ``__init__`` (no
    concurrent readers yet) is exempt.
    """
    out = []
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        scan = _ClassLockScan()
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan.scan_method(item, item.name)
        guarded = {f for f, m, _ln, locked in scan.mutations
                   if locked and m != "__init__"}
        for field, method, lineno, locked in scan.mutations:
            if locked or method == "__init__" or field not in guarded:
                continue
            if "# owner:" in ctx.line(lineno):
                continue
            out.append(Diagnostic(
                rule="lock-discipline", path=ctx.path, line=lineno,
                message=(f"{cls.name}.{field} is lock-guarded elsewhere but "
                         f"mutated without the lock in {method}()"),
                hint="hold the lock, or annotate the owning thread with "
                     "'# owner: <thread>'"))
    return out


# --------------------------------------------------------------------------- #
# blocking-in-lock — no unbounded blocking inside critical sections
# --------------------------------------------------------------------------- #
# a host/device sync in PyTorch: ``synchronize`` (a stream's, an event's or
# ``torch.cuda``'s), and the copies to the host that wait for the card
_BLOCKING_NAMES = ("synchronize", "item", "tolist", "cpu", "sleep")


class _BlockingScan(ast.NodeVisitor):
    def __init__(self, ctx: LintContext) -> None:
        self.ctx = ctx
        self.out: list[Diagnostic] = []
        self._held: list[str] = []       # dotted lock exprs currently held

    def visit_With(self, node: ast.With) -> None:
        held = [_dotted(item.context_expr) for item in node.items
                if _is_self_lockish(item.context_expr)]
        self._held.extend(h for h in held if h)
        self.generic_visit(node)
        for _ in held:
            if self._held:
                self._held.pop()

    def _flag(self, node: ast.Call, what: str, hint: str) -> None:
        self.out.append(Diagnostic(
            rule="blocking-in-lock", path=self.ctx.path, line=node.lineno,
            message=f"{what} inside a critical section "
                    f"(holding {self._held[-1]})",
            hint=hint))

    def visit_Call(self, node: ast.Call) -> None:
        if self._held:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
            if name == "result" and not node.args and not has_timeout:
                self._flag(node, "unbounded .result()",
                           "resolve futures outside the lock or pass a "
                           "timeout")
            elif name == "get" and not node.args and not has_timeout:
                self._flag(node, "queue.get() with no timeout",
                           "use get(timeout=...) or move it out of the lock")
            elif name in ("wait", "join") and not node.args \
                    and not has_timeout:
                # waiting on the HELD condition releases it — that is the
                # condition-variable idiom, not a deadlock
                recv = _dotted(fn.value) if isinstance(fn, ast.Attribute) \
                    else None
                if recv not in self._held:
                    self._flag(node, f"unbounded .{name}()",
                               "only the held condition may be waited on "
                               "inside its own lock")
            elif name in _BLOCKING_NAMES:
                self._flag(node, f"{name}() (device/host sync)",
                           "stage data and sync outside the lock")
        self.generic_visit(node)


@file_rule("blocking-in-lock")
def _rule_blocking_in_lock(ctx: LintContext) -> Iterable[Diagnostic]:
    """No unbounded blocking calls while holding a ``self.<lock>`` — a
    blocked critical section stalls every thread contending for the lock
    (the executor's rings and counters are all behind one mutex)."""
    scan = _BlockingScan(ctx)
    scan.visit(ctx.tree)
    return scan.out


# --------------------------------------------------------------------------- #
# frozen-dataclass — plan/placement dataclasses must be immutable
# --------------------------------------------------------------------------- #
_FROZEN_SCOPE = ("repro_torch/core/placement.py",
                 "repro_torch/core/partition.py", "repro_torch/analysis/")


def _dataclass_frozen(dec: ast.AST) -> Optional[bool]:
    """None if not a dataclass decorator, else its frozen-ness."""
    if isinstance(dec, ast.Name) and dec.id == "dataclass":
        return False
    if isinstance(dec, ast.Call) and isinstance(dec.func, ast.Name) \
            and dec.func.id == "dataclass":
        for kw in dec.keywords:
            if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
        return False
    return None


@file_rule("frozen-dataclass")
def _rule_frozen_dataclass(ctx: LintContext) -> Iterable[Diagnostic]:
    """Plan/placement/diagnostic dataclasses are shared across threads (the
    replanner hands them to the serving thread); they must be frozen unless
    explicitly annotated ``# lint: allow-mutable(reason)``."""
    norm = ctx.path.replace(os.sep, "/")
    if not any(s in norm for s in _FROZEN_SCOPE):
        return []
    out = []
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        frozen = [f for f in map(_dataclass_frozen, cls.decorator_list)
                  if f is not None]
        if not frozen or frozen[0]:
            continue
        if "# lint: allow-mutable" in ctx.line(cls.lineno):
            continue
        out.append(Diagnostic(
            rule="frozen-dataclass", path=ctx.path, line=cls.lineno,
            message=f"dataclass {cls.name} in a plan/placement module is "
                    f"not frozen",
            hint="use @dataclass(frozen=True) or annotate "
                 "'# lint: allow-mutable(reason)'"))
    return out


# --------------------------------------------------------------------------- #
# acquire-without-finally — manual lock acquire must release in a finally
# --------------------------------------------------------------------------- #
@file_rule("acquire-without-finally")
def _rule_acquire_without_finally(ctx: LintContext) -> Iterable[Diagnostic]:
    """Every manual ``X.acquire()`` needs an ``X.release()`` in a
    ``finally`` of the same function — the pattern whose absence turned
    the executor's close/submit race into a silent hang instead of an
    exception."""
    out = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        released: set[str] = set()
        for t in ast.walk(fn):
            if isinstance(t, ast.Try):
                for stmt in t.finalbody:
                    for call in ast.walk(stmt):
                        if (isinstance(call, ast.Call)
                                and isinstance(call.func, ast.Attribute)
                                and call.func.attr == "release"):
                            recv = _dotted(call.func.value)
                            if recv:
                                released.add(recv)
        for call in ast.walk(fn):
            if (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "acquire"):
                recv = _dotted(call.func.value)
                if recv and recv not in released:
                    out.append(Diagnostic(
                        rule="acquire-without-finally", path=ctx.path,
                        line=call.lineno,
                        message=(f"{recv}.acquire() has no matching "
                                 f"{recv}.release() in a finally block of "
                                 f"{fn.name}()"),
                        hint="use 'with' or try/finally so an exception "
                             "cannot leak the lock"))
    return out


# --------------------------------------------------------------------------- #
# swallowed-exception — broad handlers must re-raise or record the error
# --------------------------------------------------------------------------- #
@file_rule("swallowed-exception")
def _rule_swallowed_exception(ctx: LintContext) -> Iterable[Diagnostic]:
    """``except Exception`` / bare ``except`` that neither re-raises nor
    *uses* the caught error silently converts a failure into wrong state —
    the fault-tolerance layer depends on every error landing somewhere (a
    group, a stats counter, a log).  A handler passes when its body
    contains a ``raise``, or when it binds the exception (``as e``) and
    references the name.  Deliberate best-effort probes annotate the
    ``except`` line with ``# lint: allow-swallow(reason)``."""
    broad = ("Exception", "BaseException")
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        t = node.type
        if t is not None and not (isinstance(t, ast.Name)
                                  and t.id in broad):
            continue
        if "# lint: allow-swallow" in ctx.line(node.lineno):
            continue
        names = set()
        raises = False
        for sub in node.body:
            for n in ast.walk(sub):
                if isinstance(n, ast.Raise):
                    raises = True
                elif isinstance(n, ast.Name):
                    names.add(n.id)
        if raises or (node.name is not None and node.name in names):
            continue
        what = "bare except" if t is None \
            else f"except {t.id}"      # type: ignore[union-attr]
        out.append(Diagnostic(
            rule="swallowed-exception", path=ctx.path, line=node.lineno,
            message=f"{what}: handler neither re-raises nor records the "
                    "error",
            hint="re-raise, bind 'as e' and record it on a group/stats "
                 "object, or annotate '# lint: allow-swallow(reason)'"))
    return out


# --------------------------------------------------------------------------- #
# state-slot-leak — KV slot alloc without a free path in the same function
# --------------------------------------------------------------------------- #
@file_rule("state-slot-leak")
def _rule_state_slot_leak(ctx: LintContext) -> Iterable[Diagnostic]:
    """A ``pool.alloc()`` call in a function with no ``.free`` reference and
    no ``DecodeSession`` guard leaks a KV slot on any early exit — the pool
    is a fixed arena, so a leaked slot is capacity lost until process death.
    Functions that deliberately transfer slot ownership to a caller annotate
    the line with ``# lint: ignore[state-slot-leak]``.  The kvstate module
    itself (which defines the alloc/free pair) is exempt."""
    if ctx.path.replace(os.sep, "/").endswith("runtime/kvstate.py"):
        return []
    out = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        frees = False
        sessions = False
        allocs: list[ast.Call] = []
        for n in ast.walk(fn):
            if isinstance(n, ast.Attribute) and n.attr == "free":
                frees = True
            elif isinstance(n, ast.Name) and n.id == "DecodeSession":
                sessions = True
            elif (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "alloc"):
                allocs.append(n)
        if frees or sessions:
            continue
        for call in allocs:
            out.append(Diagnostic(
                rule="state-slot-leak", path=ctx.path, line=call.lineno,
                message=(f".alloc() in {fn.name}() with no .free path or "
                         f"DecodeSession guard in the same function"),
                hint="wrap the slot in DecodeSession, free it in a "
                     "finally, or annotate "
                     "'# lint: ignore[state-slot-leak]' if ownership "
                     "transfers to the caller"))
    return out


# --------------------------------------------------------------------------- #
# dead-export — public module-level defs nobody imports
# --------------------------------------------------------------------------- #
@project_rule("dead-export")
def _rule_dead_export(targets: Sequence[LintContext],
                      refs: Sequence[LintContext]) -> Iterable[Diagnostic]:
    """A public module-level def that nothing *uses* drifts silently (the
    ``spmd_pipeline`` failure mode).  Use = a Name/Attribute reference or an
    ``from x import name`` anywhere across src/tests/benchmarks/examples —
    in the def's own module, only references *outside the def itself* count
    (a def is not kept alive by its own body or recursion alone, but a
    helper its module genuinely calls is).  Re-exports from ``__init__.py``
    files do not count as use — a name whose only mention is the package
    facade is exactly the drift this rule exists to catch.  Annotate
    deliberate keeps with ``# lint: allow-dead(reason)``."""
    def used_names(tree: ast.AST, skip: ast.AST | None = None) -> set[str]:
        skip_ids = {id(n) for n in ast.walk(skip)} if skip is not None \
            else set()
        names: set[str] = set()
        for node in ast.walk(tree):
            if id(node) in skip_ids:
                continue
            if isinstance(node, ast.Name):
                names.add(node.id)
            elif isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.ImportFrom):
                names.update(a.name for a in node.names)
        return names

    by_file: dict[str, set[str]] = {}
    for ctx in refs:
        if os.path.basename(ctx.path) == "__init__.py":
            continue                       # re-exporting is not using
        by_file[os.path.abspath(ctx.path)] = used_names(ctx.tree)

    out = []
    for ctx in targets:
        base = os.path.basename(ctx.path)
        if base in ("__init__.py", "__main__.py"):
            continue
        me = os.path.abspath(ctx.path)
        other: set[str] = set()
        for path, names in by_file.items():
            if path != me:
                other |= names
        for node in ctx.tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                continue
            if node.name.startswith("_"):
                continue
            if "# lint: allow-dead" in ctx.line(node.lineno):
                continue
            own = used_names(ctx.tree, skip=node)
            if node.name in other or node.name in own:
                continue
            out.append(Diagnostic(
                rule="dead-export", path=ctx.path, line=node.lineno,
                message=(f"public def {node.name!r} is never referenced "
                         f"outside its own definition"),
                hint="wire it into a test, make it private, or mark "
                     "'# lint: allow-dead(reason)'"))
    return out


#: merged view for the CLI / docs
LINT_RULES: dict[str, object] = {**FILE_RULES, **PROJECT_RULES}


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #
def _py_files(path: str) -> list[str]:
    if os.path.isfile(path):
        return [path] if path.endswith(".py") else []
    out = []
    for root, _dirs, files in os.walk(path):
        if "__pycache__" in root:
            continue
        out.extend(os.path.join(root, f) for f in sorted(files)
                   if f.endswith(".py"))
    return sorted(out)


def _load(paths: Iterable[str]) -> list[LintContext]:
    ctxs = []
    for f in paths:
        with open(f, encoding="utf-8") as fh:
            ctxs.append(LintContext(f, fh.read()))
    return ctxs


def _suppressed(ctx_by_path: dict, d: Diagnostic) -> bool:
    ctx = ctx_by_path.get(d.path)
    if ctx is None or d.line is None:
        return False
    return f"# lint: ignore[{d.rule}]" in ctx.line(d.line)


def lint_file(ctx: LintContext) -> list[Diagnostic]:
    """Run every file rule over one parsed module."""
    out: list[Diagnostic] = []
    for fn in FILE_RULES.values():
        out.extend(fn(ctx))
    return [d for d in out if not _suppressed({ctx.path: ctx}, d)]


def lint_paths(paths: Sequence[str], *,
               ref_roots: Sequence[str] | None = None) -> list[Diagnostic]:
    """Lint every ``.py`` under ``paths``; returns all findings.

    ``ref_roots`` are the directories scanned for *references* by project
    rules (dead-export).  By default they are derived from the first
    target path: the sibling ``src``/``tests``/``benchmarks``/``examples``
    directories of the enclosing repo, so
    ``lint_paths(["src/repro_torch"])``
    counts a use in ``tests/`` or ``benchmarks/``.
    """
    files = [f for p in paths for f in _py_files(p)]
    targets = _load(files)
    if ref_roots is None:
        root = os.path.abspath(files[0] if files else ".")
        while root != os.path.dirname(root):
            if os.path.isdir(os.path.join(root, "src")):
                break
            root = os.path.dirname(root)
        ref_roots = [os.path.join(root, d)
                     for d in ("src", "tests", "benchmarks", "examples")
                     if os.path.isdir(os.path.join(root, d))]
    ref_files = {os.path.abspath(f)
                 for r in ref_roots for f in _py_files(r)}
    ref_files.update(os.path.abspath(f) for f in files)
    refs = _load(sorted(ref_files))

    out: list[Diagnostic] = []
    for ctx in targets:
        for fn in FILE_RULES.values():
            out.extend(fn(ctx))
    for fn in PROJECT_RULES.values():
        out.extend(fn(targets, refs))

    by_path = {c.path: c for c in targets}
    by_abs = {os.path.abspath(c.path): c for c in targets}
    out = [d for d in out
           if not _suppressed(by_path, d) and not _suppressed(by_abs, d)]
    out.sort(key=lambda d: (d.path or "", d.line or 0, d.rule))
    return out
