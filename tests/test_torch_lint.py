"""The port's copies of the JAX package's two lint gates.

* Single executor (``tools/check_single_executor.py`` for
  ``src/repro/core/mixing.py``, run by ``tests/test_placement.py``):
  ``src/repro_torch/core/mixing.py`` parsed with ``ast`` has exactly one
  executor builder, ``_make_exec`` (the one top-level function whose
  name ends in ``_exec``); every ``_exchange`` call (the port's
  ``ppermute``: a round's transfers between cells) lies in
  ``_make_exec`` or ``make_fused_tail``; and every cross-cell amax max
  (``torch.maximum``, the port's ``pmax`` over the model axes) lies in
  those bodies too.
* Docstrings: ``tools/check_docstrings.py src/repro_torch`` reports no
  undocumented public API.
"""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXING = os.path.join(ROOT, "src", "repro_torch", "core", "mixing.py")
EXECUTOR = "_make_exec"
SCOPES = {"_make_exec", "make_fused_tail"}


def _tree():
    with open(MIXING) as f:
        return ast.parse(f.read(), filename=MIXING)


def _calls(top, name):
    """The calls inside ``top`` to ``name`` (a bare name or an
    attribute)."""
    out = []
    for node in ast.walk(top):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Name) and f.id == name) or (
                    isinstance(f, ast.Attribute) and f.attr == name):
                out.append(node)
    return out


def _functions(tree):
    return [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def test_one_executor_builder():
    names = [n.name for n in _functions(_tree()) if n.name.endswith("_exec")]
    assert names == [EXECUTOR]


def test_every_exchange_lies_in_the_executor_or_the_fused_tail():
    tree = _tree()
    where = {top.name: len(_calls(top, "_exchange"))
             for top in _functions(tree)}
    outside = {n: k for n, k in where.items() if k and n not in SCOPES}
    assert not outside, outside
    assert where[EXECUTOR] and where["make_fused_tail"]
    # No class method or module-level statement calls it either.
    rest = [n for n in tree.body if not isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    assert not any(_calls(n, "_exchange") for n in rest)


def test_every_cross_cell_amax_max_lies_in_those_bodies():
    tree = _tree()
    where = {top.name: len(_calls(top, "maximum"))
             for top in _functions(tree)}
    outside = {n: k for n, k in where.items() if k and n not in SCOPES}
    assert not outside, outside
    assert where[EXECUTOR] == 1
    rest = [n for n in tree.body if not isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    assert not any(_calls(n, "maximum") for n in rest)


def test_public_apis_are_documented():
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "check_docstrings.py"),
         os.path.join(ROOT, "src", "repro_torch")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "clean" in r.stdout
