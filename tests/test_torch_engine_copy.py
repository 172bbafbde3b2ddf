"""The port's engine modules are copies of the reference package's NumPy host
code. Each copied module is held to its source here: both are parsed, the
docstrings are removed and ``repro`` is rewritten to ``repro_torch`` in the
reference's imports and module names, and then the two syntax trees must be equal
(so a port module that imports ``repro`` differs from its source).

``DIFFERENCES`` is the one list of places where the port departs from its
source on purpose. Each entry names rewrites that turn those places of the
port back into the reference's code (drop the ``device`` parameter, say);
the rest of each module, every function body included, is compared whole.
Run this file as a script to print what each entry rewrites as a diff,
which is all there is to read beyond the copy.
"""
import ast
import copy
import difflib
import re
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
    "core/streaming.py", "core/snapshot.py", "core/predictor.py",
    "core/advisor.py",
    "federated/__init__.py", "federated/events.py", "federated/runtime.py",
    "federated/surrogate.py", "federated/reference.py",
    "api/environment.py", "api/spec.py", "api/experiment.py",
    "api/sweep.py", "api/__init__.py", "api/__main__.py",
    "checkpoint/__init__.py", "checkpoint/io.py",
    "launch/train.py",
)


def _is_name(node, name):
    return isinstance(node, ast.Name) and node.id == name


def _call_of(node, name):
    """Whether ``node`` calls ``name`` (a function or a method)."""
    return isinstance(node, ast.Call) and (
        _is_name(node.func, name) or
        isinstance(node.func, ast.Attribute) and node.func.attr == name)


class _Rewrite(ast.NodeTransformer):
    """Visits the port's tree; ``keep(stmt)`` drops a statement where it is
    false. A rewrite of one difference subclasses it."""

    def keep(self, stmt):
        return True

    def generic_visit(self, node):
        node = super().generic_visit(node)
        for field in ("body", "orelse", "finalbody"):
            body = getattr(node, field, None)
            if isinstance(body, list) and body and \
                    isinstance(body[0], ast.stmt):
                setattr(node, field, [s for s in body if self.keep(s)]
                        or [ast.Pass()])
        return node


class _Device(_Rewrite):
    """Drop ``device``: the parameter, the argument, the keyword, the
    ``self.device``/``device`` assignments, the import of
    ``resolve_device`` and the CLIs' ``--device`` option."""

    def keep(self, stmt):
        if isinstance(stmt, ast.Assign):
            return not any(_is_name(t, "device") or isinstance(
                t, ast.Attribute) and t.attr == "device"
                for t in stmt.targets)
        if isinstance(stmt, ast.Expr) and _call_of(stmt.value,
                                                   "add_argument"):
            return not (stmt.value.args and isinstance(
                stmt.value.args[0], ast.Constant) and
                stmt.value.args[0].value == "--device")
        if isinstance(stmt, ast.ImportFrom):
            stmt.names = [a for a in stmt.names
                          if a.name != "resolve_device"]
            return bool(stmt.names)
        return True

    def visit_arguments(self, node):
        pos = node.posonlyargs + node.args
        if pos and pos[-1].arg == "device" and node.defaults:
            node.args, node.defaults = node.args[:-1], node.defaults[:-1]
        keep = [i for i, a in enumerate(node.kwonlyargs)
                if a.arg != "device"]
        node.kw_defaults = [node.kw_defaults[i] for i in keep]
        node.kwonlyargs = [node.kwonlyargs[i] for i in keep]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        node.args = [a for a in node.args if not _is_name(a, "device")]
        node.keywords = [k for k in node.keywords if k.arg != "device"]
        return node

    def visit_Tuple(self, node):         # a worker process's args
        self.generic_visit(node)
        node.elts = [e for e in node.elts if not _is_name(e, "device")]
        return node


class _RunSpec(_Rewrite):
    """``Experiment(spec).run()`` back to ``run_spec(spec)``, whose import
    the port drops."""

    def visit_ImportFrom(self, node):
        if node.module == "repro_torch.api.experiment":
            node.names.append(ast.alias("run_spec"))
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        inner = node.func.value if _call_of(node, "run") else None
        if not node.args and _call_of(inner, "Experiment"):
            return ast.Call(ast.Name("run_spec", ast.Load()), inner.args, [])
        return node


class _Spawn(_Rewrite):
    """Drop ``_mp_context``: its definition, the ``mp_context=`` of the
    pool, and ``_mp_context(specs, ctx)`` back to ``ctx``."""

    def keep(self, stmt):
        return not (isinstance(stmt, ast.FunctionDef)
                    and stmt.name == "_mp_context")

    def visit_Call(self, node):
        node.keywords = [k for k in node.keywords if k.arg != "mp_context"]
        self.generic_visit(node)
        return node.args[1] if _call_of(node, "_mp_context") else node


class _Drain(_Rewrite):
    """``alive = proc.is_alive()`` read before the poll, back to
    ``proc.is_alive()`` read after it."""

    def keep(self, stmt):
        return not (isinstance(stmt, ast.Assign) and
                    _is_name(stmt.targets[0], "alive"))

    def visit_Name(self, node):
        if node.id == "alive" and isinstance(node.ctx, ast.Load):
            return ast.Call(ast.Attribute(ast.Name("proc", ast.Load()),
                                          "is_alive", ast.Load()), [], [])
        return node


class _Message(_Rewrite):
    """The port's error message names its own learner."""

    def visit_Constant(self, node):
        if node.value == ("engine snapshots support learner='surrogate' "
                          "only; the port's real learner's parameters are "
                          "not serialized"):
            node.value = node.value.replace("port's real learner's",
                                            "real JAX learner's")
        return node


class _HostTransfer(_Rewrite):
    """``to_host(tree)`` (each tensor to host NumPy) back to
    ``jax.device_get(tree)``; ``import torch`` for ``import jax``."""

    def keep(self, stmt):
        if isinstance(stmt, ast.Import):
            return stmt.names[0].name not in ("torch", "jax")
        return not (isinstance(stmt, ast.FunctionDef)
                    and stmt.name == "to_host")

    def visit_Call(self, node):
        self.generic_visit(node)
        if _call_of(node, "to_host"):
            node.func = ast.Attribute(ast.Name("jax", ast.Load()),
                                      "device_get", ast.Load())
        return node


# (module, rewrites, reason): the rewrites turn the port's module back into
# its source where the reason says it departs. _HostTransfer also drops the
# reference's ``import jax``, the one rewrite of the reference's tree.
DIFFERENCES = (
    ("api/experiment.py", (_Device,),
     "takes device= and builds the port's RealLearner on "
     "resolve_device(device), so a real run without a card raises"),
    ("api/experiment.py", (_Message,),
     "its error for a real learner names the port's learner, not JAX's"),
    ("api/sweep.py", (_Device, _RunSpec),
     "device= (default \"cuda\") travels from sweep() through the jobs and "
     "the worker processes to Experiment(spec, device=device); _run_job "
     "builds that Experiment in place of run_spec(spec)"),
    ("api/sweep.py", (_Spawn,),
     "a job with a real-learner spec runs in a worker started with "
     "\"spawn\" (a forked child cannot use CUDA again)"),
    ("api/sweep.py", (_Drain,),
     "the fault-tolerant scheduler reads is_alive() before it polls the "
     "pipe, so a worker that sends and exits between the two checks is "
     "read, not counted as died"),
    ("api/__main__.py", (_Device,),
     "--device (default cuda), passed to Experiment, where a real learner "
     "runs"),
    ("checkpoint/io.py", (_HostTransfer,),
     "each torch.Tensor leaf moves to host NumPy in place of "
     "jax.device_get; a bfloat16 leaf raises"),
    ("launch/train.py", (_Device,),
     "--device (default cuda), passed to Experiment, where the real "
     "learner runs"),
)


def _rename(module):
    if module == "repro" or (module or "").startswith("repro."):
        return "repro_torch" + module[len("repro"):]
    return module


class _Normalise(ast.NodeTransformer):
    """Drop docstrings; with ``rename``, rewrite ``repro`` to
    ``repro_torch`` in imports and in a string that names a module of it
    (the spec CLI's ``prog``)."""

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

    def visit_Constant(self, node):
        if self.rename and isinstance(node.value, str) and \
                re.fullmatch(r"repro(\.\w+)*", node.value):
            node.value = _rename(node.value)
        return node


def _trees(module):
    ref = (SRC / "repro" / module).read_text()
    port = (SRC / "repro_torch" / module).read_text()
    return (_Normalise(rename=True).visit(ast.parse(ref)),
            _Normalise(rename=False).visit(ast.parse(port)))


def _apply(module, ref, port, differences=DIFFERENCES):
    """Apply the module's rewrites to the port's tree (and _HostTransfer's
    import drop to the reference's); returns the port's tree."""
    for mod, rewrites, _ in differences:
        if mod != module:
            continue
        for rewrite in rewrites:
            port = ast.fix_missing_locations(rewrite().visit(port))
            if rewrite is _HostTransfer:
                ref.body = [s for s in ref.body if _HostTransfer().keep(s)]
    return port


def _diff(a, b, name):
    return "\n".join(difflib.unified_diff(
        a.splitlines(), b.splitlines(), f"repro/{name}",
        f"repro_torch/{name}", lineterm=""))


@pytest.mark.parametrize("module", MODULES)
def test_module_is_a_copy_of_the_reference(module):
    ref, port = _trees(module)
    port = _apply(module, ref, port)
    if ast.dump(ref) != ast.dump(port):
        pytest.fail("the port's copy departs from the reference outside "
                    "DIFFERENCES:\n"
                    + _diff(ast.unparse(ref), ast.unparse(port), module))


def test_each_listed_difference_is_real():
    """Eight differences, each in a copied module; each of its rewrites
    changes the port's tree, and without it the module no longer equals
    its source (a difference that no longer differs must leave the
    list)."""
    assert len(DIFFERENCES) == 8
    for entry in DIFFERENCES:
        module, rewrites, reason = entry
        assert module in MODULES and rewrites and reason
        others = [e for e in DIFFERENCES if e is not entry]
        ref, port = _trees(module)
        port = _apply(module, ref, port, others)
        assert ast.dump(ref) != ast.dump(port), (module, reason)
        for rewrite in rewrites:
            before = ast.dump(port)
            port = _apply(module, ref, port, [(module, (rewrite,), "")])
            assert ast.dump(port) != before, (module, rewrite.__name__)


def test_every_engine_module_is_checked():
    """Every module of the port's api/, core/ and checkpoint/ is a checked
    copy."""
    ported = {p.relative_to(SRC / "repro_torch").as_posix()
              for d in ("api", "core", "checkpoint")
              for p in (SRC / "repro_torch" / d).glob("*.py")}
    assert ported <= set(MODULES)


if __name__ == "__main__":
    for module, rewrites, reason in DIFFERENCES:
        ref, port = _trees(module)
        before = ast.unparse(port)
        after = ast.unparse(_apply(module, ref, copy.deepcopy(port),
                                   [(module, rewrites, reason)]))
        names = ", ".join(r.__name__ for r in rewrites)
        print(f"# {module}: {names}: {reason}")
        print("\n".join(difflib.unified_diff(
            after.splitlines(), before.splitlines(), f"repro/{module}",
            f"repro_torch/{module}", lineterm="")))
        print()
    sys.exit(0)
