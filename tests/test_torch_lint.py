"""The port's linter and analysis CLI on the CPU, held against the JAX
package's.

* every rule's snippets of ``tests/test_verify.py`` (and the
  swallowed-exception ones of ``tests/test_faults.py``) through both
  linters: the same ``(rule, line)`` findings, a JAX path under
  ``src/repro`` read as the same path under ``src/repro_torch``;
* ``blocking-in-lock`` knows PyTorch's host/device syncs (a stream's, an
  event's or ``torch.cuda``'s ``synchronize``, ``.item()``, ``.tolist()``,
  ``.cpu()``), which JAX's linter does not;
* the gate: ``lint_paths(["src/repro_torch"])`` finds nothing;
* ``python -m repro_torch.analysis lint|verify`` print what
  ``python -m repro.analysis`` prints, with its exit codes, on the same
  files and IR/plan JSON.
"""
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import lint as JL
from repro.core import linear_ir, partition_optimal
from repro_torch.analysis import LINT_RULES, lint_paths
from repro_torch.analysis import lint as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOCKED_CLASS = """
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump(self):
        with self._lock:
            self.n += 1

    def sneak(self):
        self.n = 5{owner}
"""

DATACLASS_SRC = """
from dataclasses import dataclass

@dataclass{frozen}
class P:{pragma}
    x: int = 0
"""

# (JAX path, source): the snippets of tests/test_verify.py's lint tests
FILE_CASES = [
    ("src/repro/core/pipeline.py", 'MODE = "hw"\n'),
    ("src/repro/core/placement.py", 'MODE = "hw"\n'),
    ("src/repro/core/x.py", 'def f():\n    "hw"\n'),
    ("src/repro/core/x.py", 'M = "hw"  # lint: ignore[placement-literal]\n'),
    ("m.py", LOCKED_CLASS.format(owner="")),
    ("m.py", LOCKED_CLASS.format(owner="  # owner: stats thread")),
    ("m.py", """
    class Q:
        def take(self, fut):
            with self._lock:
                return fut.result()
    """),
    ("m.py", """
    class Q:
        def take(self, fut):
            with self._lock:
                return fut.result(timeout=1.0)
    """),
    ("m.py", """
    import time

    class Q:
        def nap(self):
            with self._lock:
                time.sleep(1.0)
    """),
    ("src/repro/analysis/synth.py", DATACLASS_SRC.format(frozen="",
                                                         pragma="")),
    ("src/repro/core/executor.py", DATACLASS_SRC.format(frozen="",
                                                        pragma="")),
    ("src/repro/analysis/synth.py", DATACLASS_SRC.format(
        frozen="(frozen=True)", pragma="")),
    ("src/repro/analysis/synth.py", DATACLASS_SRC.format(
        frozen="", pragma="  # lint: allow-mutable(test double)")),
    ("m.py", """
    def f(lock):
        lock.acquire()
        work()
        lock.release()
    """),
    ("m.py", """
    def f(lock):
        lock.acquire()
        try:
            work()
        finally:
            lock.release()
    """),
    ("clean.py", "X = 1\n"),
]

# tests/test_faults.py's swallowed-exception modules (through lint_paths)
SWALLOW_CASES = [
    ("def f():\n    try:\n        g()\n    except Exception:\n        pass\n"
     "def h():\n    try:\n        g()\n    except:\n        x = 1\n"),
    ("def a():\n    try:\n        g()\n    except Exception:\n        raise\n"
     "def b(log):\n    try:\n        g()\n    except Exception as e:\n"
     "        log.append(e)\n"
     "def c():\n    try:\n        g()\n"
     "    except Exception:  # lint: allow-swallow(best-effort probe)\n"
     "        pass\n"
     "def d():\n    try:\n        g()\n    except ValueError:\n        pass\n"),
]


def _found(mod, path, src):
    ctx = mod.LintContext(path, textwrap.dedent(src))
    return sorted((d.rule, d.line) for d in mod.lint_file(ctx))


def test_rule_ids_are_the_jax_linters():
    assert set(TL.FILE_RULES) == set(JL.FILE_RULES)
    assert set(TL.PROJECT_RULES) == set(JL.PROJECT_RULES)
    assert set(LINT_RULES) == set(JL.LINT_RULES)


@pytest.mark.parametrize("case", range(len(FILE_CASES)))
def test_file_rule_snippets_give_the_jax_findings(case):
    path, src = FILE_CASES[case]
    mine = path.replace("src/repro/", "src/repro_torch/")
    assert _found(TL, mine, src) == _found(JL, path, src)


def test_dead_export_snippet_gives_the_jax_findings():
    a = textwrap.dedent("""
        def used():
            return 1

        def dead():
            return 2

        def kept():  # lint: allow-dead(public API)
            return 3

        def helper():
            return 4

        def recursive():
            return recursive()

        _x = helper()
    """)
    out = []
    for mod in (TL, JL):
        mod_a = mod.LintContext("src/pkg/a.py", a)
        refs = [mod_a, mod.LintContext("src/pkg/b.py",
                                       "from pkg.a import used\n"),
                mod.LintContext("src/pkg/__init__.py",
                                "from .a import dead\n")]
        out.append(sorted((d.rule, d.line, d.message) for d in
                          mod.PROJECT_RULES["dead-export"]([mod_a], refs)))
    assert out[0] == out[1] and len(out[0]) == 2


@pytest.mark.parametrize("case", range(len(SWALLOW_CASES)))
def test_swallowed_exception_modules_give_the_jax_findings(tmp_path, case):
    f = tmp_path / "mod.py"
    f.write_text(SWALLOW_CASES[case])
    got = [(d.rule, d.line) for d in lint_paths([str(f)])]
    assert got == [(d.rule, d.line) for d in JL.lint_paths([str(f)])]
    swallowed = [g for g in got if g[0] == "swallowed-exception"]
    assert len(swallowed) == (2 if case == 0 else 0)


def test_blocking_in_lock_knows_the_torch_syncs():
    src = """
    import time
    import torch

    class Stage:
        def retire(self, ev, stream, t):
            with self._lock:
                ev.synchronize()
                stream.synchronize()
                torch.cuda.synchronize()
                n = t.sum().item()
                rows = t.tolist()
                host = t.cpu()
                time.sleep(0.1)
            ev.synchronize()               # outside the lock: fine
            return n, rows, host
    """
    got = _found(TL, "src/repro_torch/core/x.py", src)
    assert got == [("blocking-in-lock", n) for n in range(8, 15)]
    # the JAX linter knows only sleep of these
    assert _found(JL, "src/repro/core/x.py", src) == [
        ("blocking-in-lock", 14)]


def test_the_port_lints_clean():
    assert lint_paths([os.path.join(ROOT, "src", "repro_torch")]) == []


def _cli(pkg, *args):
    env = {**os.environ,
           "PYTHONPATH": os.path.join(ROOT, "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-m", f"{pkg}.analysis", *args],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    return r.returncode, r.stdout


def test_cli_lint_and_verify_print_what_the_jax_cli_prints(tmp_path):
    assert _cli("repro_torch", "lint") == (
        0, "0 finding(s) in src/repro_torch\n")
    bad = tmp_path / "mod.py"
    bad.write_text(SWALLOW_CASES[0])
    rc, out = _cli("repro_torch", "lint", str(bad))
    assert (rc, out) == _cli("repro", "lint", str(bad))
    assert rc == 1 and out.count("error[swallowed-exception]") == 2

    ir = linear_ir("t", ["a", "b", "c", "d"], [1.0, 4.0, 2.0, 1.0],
                   io_shape=(64, 96))
    plan = partition_optimal(ir, max_stages=3)
    (tmp_path / "ir.json").write_text(ir.to_json())
    (tmp_path / "plan.json").write_text(plan.to_json())
    plan.stages[1].node_names = []                 # a stage with no node
    plan.stages[2].node_names.append("zz")         # and an unknown one
    (tmp_path / "bad.json").write_text(plan.to_json())
    irf = str(tmp_path / "ir.json")
    for args in ([irf], [irf, "--policy", "paper"],
                 [irf, "--plan", str(tmp_path / "plan.json")],
                 [irf, "--plan", str(tmp_path / "bad.json")]):
        mine = _cli("repro_torch", "verify", *args)
        assert mine == _cli("repro", "verify", *args), args
    assert mine[0] == 1 and "error" in mine[1]
