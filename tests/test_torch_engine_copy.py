"""The port's engine modules are copies of the reference package's NumPy host
code. Each copied module is held to its source here: both are parsed, the
docstrings are removed and ``repro`` is rewritten to ``repro_torch`` in the
reference's import statements, and then the two syntax trees must be equal
(so a port module that imports ``repro`` differs from its source).

``DIFFERENCES`` is the one list of places where the port departs from its
source on purpose. Run this file as a script to print those places as a
diff of the two sources, which is all there is to read beyond the copy.
"""
import ast
import difflib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"

MODULES = (
    "core/__init__.py", "core/carbon.py", "core/profiles.py",
    "core/network.py", "core/energy.py", "core/telemetry.py",
    "core/estimator.py", "core/faults.py", "core/availability.py",
    "core/streaming.py", "core/snapshot.py",
    "federated/__init__.py", "federated/events.py", "federated/runtime.py",
    "federated/surrogate.py",
    "api/environment.py", "api/spec.py", "api/experiment.py",
    "api/__init__.py",
)

# (module, names, reason): a name is a function's qualified name, whose
# whole definition is left out of the comparison, or a name the reference
# imports into the module, whose import and ``__all__`` entry the port
# leaves out.
DIFFERENCES = (
    ("api/experiment.py", ("Experiment.__init__", "Experiment._make_learner"),
     "takes device= and builds the port's RealLearner on "
     "resolve_device(device), so a real run without a card raises"),
    ("api/experiment.py", ("Experiment._snapshot_hook",),
     "its error for a real learner names the port's learner, not JAX's"),
    ("api/__init__.py", ("sweep",),
     "api/sweep.py is not ported yet, so sweep is neither imported nor "
     "exported"),
)


def _rename(module):
    if module == "repro" or (module or "").startswith("repro."):
        return "repro_torch" + module[len("repro"):]
    return module


class _Normalise(ast.NodeTransformer):
    """Drop docstrings; with ``rename``, rewrite ``repro`` to
    ``repro_torch`` in imports."""

    def __init__(self, rename):
        self.rename = rename

    def _strip_doc(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            keep = [] if isinstance(node, ast.Module) else [ast.Pass()]
            node.body = body[1:] or keep
        return node

    visit_Module = visit_ClassDef = _strip_doc
    visit_FunctionDef = visit_AsyncFunctionDef = _strip_doc

    def visit_ImportFrom(self, node):
        if self.rename and node.level == 0:
            node.module = _rename(node.module)
        return node

    def visit_Import(self, node):
        if self.rename:
            for alias in node.names:
                alias.name = _rename(alias.name)
        return node


def _defs(tree):
    """Qualified name -> (parent body, index) of every function."""
    out = {}

    def walk(body, prefix):
        for i, node in enumerate(body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                name = prefix + node.name
                if not isinstance(node, ast.ClassDef):
                    out[name] = (body, i)
                walk(node.body, name + ".")
    walk(tree.body, "")
    return out


def _drop_import(tree, name):
    """Remove ``name`` from the module's imports and its ``__all__``;
    returns whether it was found in both."""
    found = set()
    for node in list(tree.body):
        if isinstance(node, ast.ImportFrom):
            kept = [a for a in node.names if (a.asname or a.name) != name]
            if len(kept) < len(node.names):
                found.add("import")
                node.names = kept
                if not kept:
                    tree.body.remove(node)
        elif isinstance(node, ast.Assign) and \
                any(isinstance(t, ast.Name) and t.id == "__all__"
                    for t in node.targets):
            elts = node.value.elts
            kept = [e for e in elts if not (isinstance(e, ast.Constant)
                                             and e.value == name)]
            if len(kept) < len(elts):
                found.add("__all__")
                node.value.elts = kept
    return found == {"import", "__all__"}


def _trees(module):
    ref = (SRC / "repro" / module).read_text()
    port = (SRC / "repro_torch" / module).read_text()
    return (_Normalise(rename=True).visit(ast.parse(ref)),
            _Normalise(rename=False).visit(ast.parse(port)))


def _apply_differences(module, ref, port, differences=DIFFERENCES):
    """Blank the listed functions in both trees and drop the listed
    imports from the reference; returns (name, reference source, port
    source) for each name left out."""
    shown = []
    rdefs, pdefs = _defs(ref), _defs(port)
    for mod, names, _ in differences:
        if mod != module:
            continue
        for name in names:
            if name in rdefs or name in pdefs:
                assert name in rdefs and name in pdefs, (module, name)
                (rb, ri), (pb, pi) = rdefs[name], pdefs[name]
                shown.append((name, ast.unparse(rb[ri]), ast.unparse(pb[pi])))
                rb[ri] = ast.Pass()
                pb[pi] = ast.Pass()
            else:
                assert _drop_import(ref, name), (module, name)
                shown.append((name, f"import {name}", ""))
    return shown


def _diff(a, b, name):
    return "\n".join(difflib.unified_diff(
        a.splitlines(), b.splitlines(), f"repro/{name}",
        f"repro_torch/{name}", lineterm=""))


@pytest.mark.parametrize("module", MODULES)
def test_module_is_a_copy_of_the_reference(module):
    ref, port = _trees(module)
    _apply_differences(module, ref, port)
    if ast.dump(ref) != ast.dump(port):
        pytest.fail("the port's copy departs from the reference outside "
                    "DIFFERENCES:\n"
                    + _diff(ast.unparse(ref), ast.unparse(port), module))


def test_each_listed_difference_is_real():
    """Three differences, each in a copied module, and each one changes
    what it names (a difference that no longer differs must leave the
    list)."""
    assert len(DIFFERENCES) == 3
    for entry in DIFFERENCES:
        module, names, reason = entry
        assert module in MODULES and names and reason
        ref, port = _trees(module)
        shown = _apply_differences(module, ref, port, [entry])
        assert [name for name, _, _ in shown] == list(names)
        for name, a, b in shown:
            assert a != b, (module, name)


def test_every_engine_module_is_checked():
    """Every module of the port's api/ and core/ is a checked copy."""
    ported = {p.relative_to(SRC / "repro_torch").as_posix()
              for d in ("api", "core")
              for p in (SRC / "repro_torch" / d).glob("*.py")}
    assert ported <= set(MODULES)


if __name__ == "__main__":
    for entry in DIFFERENCES:
        module, _, reason = entry
        ref, port = _trees(module)
        for name, a, b in _apply_differences(module, ref, port, [entry]):
            print(f"# {module}: {name}: {reason}")
            print(_diff(a, b, f"{module}::{name}"))
            print()
    sys.exit(0)
