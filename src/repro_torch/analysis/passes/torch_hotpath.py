"""host-sync / jit-unhashable-default: PyTorch hot-path hygiene — the
port's counterpart of the reference's ``jax_hotpath`` pass.

A CUDA launch returns before the card has finished; reading a value
back (``x.item()``, ``int(x)``, ``x.cpu()``) waits for every launch
queued before it and copies to the host, turning an asynchronous
pipeline into a synchronous round trip.  Where the host needs the
value (to size a launch, to pick a plan), the sync is the design and
carries a suppression that says why; anywhere else it is a stall.

The reference's pass cannot see this package: its sources are
``jnp``/``lax``/``pl`` calls, and its directory scope needs a path
component ``repro`` (``repro/analysis/passes/jax_hotpath.py``), so over
``src/repro_torch`` it reports nothing.  This pass keeps its structure
and its rule ids, so ``--select host-sync`` works alike in both
packages.

Rules, scoped to the modules where device values live —
``core/engine.py``, ``core/distributed.py``, and ``kernels/``,
``models/`` and ``runtime/`` under a ``repro_torch`` path component:

* ``host-sync`` — per-function taint analysis.  Sources: calls rooted
  at ``torch`` / ``F`` (``torch.nn.functional``) but for those that
  return host values (``torch.cuda.*``, ``torch.device``, ...), method
  calls on a tainted receiver that return tensors, parameters of
  ``torch.compile`` / ``torch.jit.script`` functions and parameters
  annotated ``torch.Tensor``, and attribute reads that read as device
  tensors (delta / graph tensor fields).
  Attribute access (but for ``shape``, ``dtype``, ``device`` and the
  like), subscripts, arithmetic, assignment and iteration (a loop's
  target over a tainted iterable) propagate taint.
  Sinks: ``float()`` / ``int()`` / ``bool()`` / ``np.asarray()`` /
  ``np.array()`` over a tainted value; ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``.numpy()`` on a tainted receiver; and every
  ``torch.cuda.synchronize()``.

* ``jit-unhashable-default`` — a function decorated with
  ``torch.compile`` or ``torch.jit.script`` (bare, called, or via
  ``functools.partial``) whose signature carries a mutable default.
  The port compiles nothing today (its kernels are CUDA C++), so this
  rule only guards code to come.

Heuristic (no type inference); suppress a justified host copy with
``# graphlint: ignore[host-sync] <why>``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.base import (Finding, LintPass, ParsedFile,
                                       attr_chain)
from repro_torch.analysis.registry import register

_SCOPE_SUFFIXES = ("core/engine.py", "core/distributed.py")
_SCOPE_DIRS = ("kernels", "models", "runtime")

#: call roots whose results are tensors
_DEVICE_ROOTS = frozenset({"torch", "F"})
#: torch.<name> calls and namespaces that return host values
_HOST_TORCH = frozenset({
    "cuda", "device", "dtype", "iinfo", "finfo", "is_tensor",
    "is_floating_point", "is_complex", "numel", "get_default_dtype",
    "backends", "Size", "Generator", "manual_seed", "no_grad",
    "inference_mode", "enable_grad", "set_grad_enabled",
    "use_deterministic_algorithms", "are_deterministic_algorithms_enabled",
    "compile", "jit", "utils", "library", "ops",
})
#: tensor methods that return host values, not tensors
_HOST_METHODS = frozenset({
    "dim", "ndimension", "size", "numel", "nelement", "element_size",
    "stride", "storage_offset", "data_ptr", "is_contiguous",
    "is_floating_point", "get_device", "type", "__len__",
})
#: tensor attributes that are host values
_HOST_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                         "layout", "requires_grad", "itemsize"})
#: method sinks: each copies the receiver to the host
_SINK_METHODS = ("item", "tolist", "cpu", "numpy")

#: (receiver hint, attr) pairs that read as device-tensor fields: the
#: reference's table, plus the node index's CSR arrays
_DEVICE_RECEIVERS = frozenset({"delta", "graph", "anchor", "snap",
                               "current", "index"})
_DEVICE_ATTRS = frozenset({"op", "u", "v", "slot", "t", "adj", "emask",
                           "eu", "ev", "deg", "mask", "row_ptr", "op_idx"})

_CONVERTERS = frozenset({"float", "int", "bool", "complex"})
_MUTABLE_DEFAULTS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)
_MUTABLE_CTORS = frozenset({"list", "dict", "set", "bytearray"})
_COMPILERS = (("torch", "compile"), ("torch", "jit", "script"),
              ("compile",), ("script",))


def _is_compile_decorator(dec: ast.AST) -> bool:
    if attr_chain(dec) in _COMPILERS:
        return True
    if isinstance(dec, ast.Call):
        fchain = attr_chain(dec.func)
        if fchain in _COMPILERS:
            return True
        if fchain and fchain[-1] == "partial" and dec.args:
            return attr_chain(dec.args[0]) in _COMPILERS
    return False


def _is_tensor_annotation(ann: ast.AST | None) -> bool:
    """``torch.Tensor`` / ``Tensor``, alone or in a ``X | None``."""
    if ann is None:
        return False
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _is_tensor_annotation(ann.left) or \
            _is_tensor_annotation(ann.right)
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in ("torch.Tensor", "Tensor")
    return attr_chain(ann) in (("torch", "Tensor"), ("Tensor",))


class _Taint:
    """Flow-insensitive per-function taint: names assigned (anywhere in
    the function) from a tensor-valued expression are tainted."""

    def __init__(self, fn: ast.FunctionDef, compiled: bool):
        self.names: set[str] = set()
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if compiled or _is_tensor_annotation(a.annotation):
                self.names.add(a.arg)
        if compiled:
            for a in (args.vararg, args.kwarg):
                if a is not None:
                    self.names.add(a.arg)
        # fixpoint over assignments and loop targets
        changed = True
        while changed:
            changed = False
            for node in ast.walk(fn):
                targets: list[ast.AST] = []
                value = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) \
                        and node.value is not None:
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.AugAssign):
                    targets, value = [node.target], node.value
                elif isinstance(node, (ast.For, ast.comprehension)):
                    targets, value = [node.target], node.iter
                if value is None or not self.tainted(value):
                    continue
                for t in targets:
                    for name in _target_names(t):
                        if name not in self.names:
                            self.names.add(name)
                            changed = True

    def tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[0] in _DEVICE_ROOTS:
                return not (chain[0] == "torch" and len(chain) > 1
                            and chain[1] in _HOST_TORCH)
            # a method of a tainted receiver returns a tensor (x.sum(),
            # x.to(...)) — except the sinks and the host-valued methods
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr not in _SINK_METHODS \
                    and node.func.attr not in _HOST_METHODS \
                    and self.tainted(node.func.value):
                return True
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return False
            chain = attr_chain(node)
            if chain:
                hints = [p for p in chain[:-1] if p != "self"]
                if hints and hints[-1] in _DEVICE_RECEIVERS \
                        and chain[-1] in _DEVICE_ATTRS:
                    return True
            return self.tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) or self.tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand)
        if isinstance(node, ast.Compare):
            return (self.tainted(node.left)
                    or any(self.tainted(c) for c in node.comparators))
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.tainted(e) for e in node.elts)
        return False


def _target_names(t: ast.AST):
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for el in t.elts:
            yield from _target_names(el)
    elif isinstance(t, ast.Starred):
        yield from _target_names(t.value)


@register
class TorchHotPathPass(LintPass):
    name = "torch-hotpath"
    description = ("implicit device→host syncs (float/int/bool/"
                   "np.asarray/.item/.tolist/.cpu/.numpy on tensors, "
                   "torch.cuda.synchronize) and unhashable compiled-"
                   "function defaults in engine/distributed/kernels/"
                   "models/runtime")
    rules = ("host-sync", "jit-unhashable-default")

    def applies(self, pf: ParsedFile) -> bool:
        if any(pf.endswith(sfx) for sfx in _SCOPE_SUFFIXES):
            return True
        return pf.in_dir(*_SCOPE_DIRS) and "repro_torch" in pf.relparts

    def check_file(self, pf: ParsedFile) -> list[Finding]:
        out: list[Finding] = []
        for fn in ast.walk(pf.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            compiled = any(_is_compile_decorator(d)
                           for d in fn.decorator_list)
            if compiled:
                out.extend(self._check_defaults(pf, fn))
            out.extend(self._check_syncs(pf, fn, compiled))
        return out

    def _check_defaults(self, pf: ParsedFile,
                        fn: ast.FunctionDef) -> list[Finding]:
        out = []
        defaults = list(fn.args.defaults) + [
            d for d in fn.args.kw_defaults if d is not None]
        for d in defaults:
            bad = isinstance(d, _MUTABLE_DEFAULTS) or (
                isinstance(d, ast.Call)
                and attr_chain(d.func) in
                tuple((n,) for n in _MUTABLE_CTORS))
            if bad:
                out.append(self.finding(
                    "jit-unhashable-default", pf, d.lineno,
                    f"compiled function {fn.name}() has a mutable "
                    "default argument — a guard on its identity "
                    "recompiles per call; use None or a tuple"))
        return out

    def _check_syncs(self, pf: ParsedFile, fn: ast.FunctionDef,
                     compiled: bool) -> list[Finding]:
        out = []
        taint = _Taint(fn, compiled)
        where = "inside compiled " if compiled else "in "
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if chain == ("torch", "cuda", "synchronize"):
                out.append(self.finding(
                    "host-sync", pf, node.lineno,
                    f"torch.cuda.synchronize() {where}{fn.name}() "
                    "blocks the host until every queued launch has "
                    "finished"))
                continue
            # float(x) / int(x) / bool(x) / np.asarray(x) on tensors
            conv = None
            if len(chain) == 1 and chain[0] in _CONVERTERS:
                conv = chain[0]
            elif chain in (("np", "asarray"), ("np", "array"),
                           ("numpy", "asarray"), ("numpy", "array")):
                conv = ".".join(chain)
            if conv and node.args and taint.tainted(node.args[0]):
                out.append(self.finding(
                    "host-sync", pf, node.lineno,
                    f"{conv}() over a tensor {where}{fn.name}() forces "
                    "a blocking device→host sync — keep it on the "
                    "device or hoist the transfer off the hot path"))
                continue
            # .item() / .tolist() / .cpu() / .numpy() on a tensor
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SINK_METHODS \
                    and taint.tainted(node.func.value):
                out.append(self.finding(
                    "host-sync", pf, node.lineno,
                    f".{node.func.attr}() on a tensor {where}"
                    f"{fn.name}() forces a blocking device→host sync"))
        return out
