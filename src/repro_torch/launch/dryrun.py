"""The multi-pod dry-run — counterpart of ``repro/launch/dryrun.py``:
trace one train, prefill or decode step of every (architecture × input
shape) cell on the production meshes, with nothing allocated, and
extract the roofline's inputs.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done]

Results land in build/dryrun/<mesh>[__tag]/<arch>__<shape>.json.

The reference lowers and compiles each cell under GSPMD and reads XLA's
analyses of the per-device program.  The port has no compiler, so a
cell is one eager step, traced:

* **The mesh**: ``launch/mesh.py``'s production mesh (16 × 16, or
  2 × 16 × 16 with ``multi_pod``) of processes in ONE process, rank 0
  of torch.distributed's ``"fake"`` process group (its collectives
  return at once; ``fake_group``).  The group is process-global, so it
  owns its process: ``run_cell`` refuses to start where a real group is
  up (tests and ``chip_smoke.py`` call it in a subprocess).
* **The inputs**: the training state, the batch (``models.api.
  input_specs``) and the decode caches are ``FakeTensorMode`` tensors —
  shapes and dtypes, no storage — placed as DTensors by
  ``state_sharding``, ``batch_sharding`` and ``cache_sharding``, each
  process keeping its chunk with no communication.
* **FLOPs and bytes a device** (``Trace``): ONE ``TorchDispatchMode``
  counts the ops on rank 0's local tensors only.  An op whose arguments
  are DTensors is handed on (``NotImplemented``) and the local op
  beneath it is counted instead (hazard (x)); so are ops under
  DTensor's own sharding propagation, which runs in a fake mode of its
  own, or in the dry-run's own fake mode (``_propagation_marked``).
  FLOPs come from ``torch.utils.flop_counter``'s registry (B5 and
  B6 register their plain versions' counts).  Bytes are the input and
  output bytes of every local op that is not a view (nor an allocation
  alone): eager PyTorch runs unfused, so this is the port's own memory
  traffic, not XLA's post-fusion count.
* **Collective bytes a device**: the operand bytes of every collective
  rank 0 issues, by the reference's kinds — DTensor's functional
  collectives and the in-place ``dist.all_reduce`` calls of
  ``sharding`` and ``optim/compress.py`` both (hazard (y)).
* **Memory** (``memory_analysis``): ``MemTracker`` over the traced
  step: the argument bytes (state and batch, or parameters, caches and
  token), the output bytes, the peak and the temporaries (peak less
  arguments).  The reference's ``generated_code_size_in_bytes`` has no
  counterpart, and neither has its ``raw_cost_analysis``: an eager
  trace counts every layer and has no loop body counted once.
* **Timings**: ``setup_s`` (the fake state placed) and ``trace_s``
  (the step traced) take the place of the reference's ``lower_s`` and
  ``compile_s``.

``device="cuda"`` (the default, as at every entry point of the port)
traces the card's path: B5 and B6 through their operators' fake
implementations.  ``device="cpu"`` traces the plain versions — the
counterpart of the reference's ``--attn xla``, since the port has no
attention switch (``models/attention.py``); ``main``'s ``--device``
replaces ``--attn``.  On a torch build without CUDA a fake CUDA tensor
needs a device guard and CUDA hooks the build lacks: ``fake_cuda.cpp``,
built with the host compiler at first use and preloaded into a process
of its own (``fake_cuda_env``; ``main`` restarts itself so).

``batch_sharding`` splits every batch leaf's first axis over the
``batch`` axes where it divides; ``state_sharding`` places a training
state (or a model) by ``sharding.PARAM_RULES``; ``cache_sharding``
places decode caches by the reference's cache rules
(``sharding.cache_spec``).  Each returns ``{leaf name: NamedSharding}``
(names as ``checkpoint.io.leaves`` gives them; a cache's as
``cache_leaves``); ``sharding.place`` puts a tensor there and
``runtime.elastic.place_tree`` a whole tree.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import SHAPES, ShardingConfig, TrainConfig
from repro_torch.obs import clock
from repro_torch.sharding import (NamedSharding, cache_spec, logical_rules,
                                  mesh_context, named_shardings, resolve)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULTS = os.path.join(_ROOT, "build", "dryrun")


# ---------------------------------------------------------------------------
# Sharding specs for the dry-run inputs
# ---------------------------------------------------------------------------


def batch_sharding(tree, mesh) -> dict:
    from repro_torch.checkpoint.io import leaves
    with mesh_context(mesh):
        out = {}
        for name, leaf in leaves(tree):
            shape = np.shape(leaf)
            out[name] = NamedSharding(mesh, (resolve("batch", shape[0]),)
                                      + (None,) * (len(shape) - 1))
        return out


def state_sharding(state, mesh) -> dict:
    return named_shardings(state, mesh)


def cache_leaves(caches):
    """(name, name within its group, leaf) for every tensor of decode
    caches as ``models.api.prefill`` returns them (one dict a group, or
    a decoder layer: ``0/l0/k``, ``0/l0/pos_map``, ``3/xk``)."""
    from repro_torch.checkpoint.io import leaves
    for g, group in enumerate(caches):
        for rel, leaf in leaves(group):
            yield f"{g}/{rel}", rel, leaf


def cache_sharding(tree, mesh) -> dict:
    """Decode caches' placement (the reference's ``cache_sharding`` on
    its stacked caches, ``sharding.cache_spec`` with the group entry
    dropped): ``{leaf name: NamedSharding}`` for the leaves of
    ``cache_leaves``, as ``runtime.elastic.place_tree`` takes it."""
    with mesh_context(mesh):
        return {name: NamedSharding(mesh, cache_spec(rel, np.shape(leaf)))
                for name, rel, leaf in cache_leaves(tree)}


# ---------------------------------------------------------------------------
# Counting one step: FLOPs, bytes and collectives of rank 0's local ops
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d ops whose first argument is the output buffer: their operand is
# the second
_OUTPUT_FIRST = ("allgather_", "_allgather_base_",
                 "allgather_into_tensor_coalesced_", "reduce_scatter_",
                 "_reduce_scatter_base_", "reduce_scatter_tensor_coalesced_",
                 "alltoall_", "alltoall_base_")
# ops that only allocate: no byte is read or written
_ALLOCATE = ("empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided")


def collective_kind(func) -> str | None:
    """The reference's kind of a collective op (its own name for any
    other collective), or None for an op that is not one."""
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = func._opname
    if name in ("wait_tensor", "barrier", "monitored_barrier_",
                "_wrap_tensor_autograd"):
        return None
    for key, kind in (("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("allreduce", "all-reduce"), ("gather", "all-gather"),
                      ("to_all", "all-to-all"), ("alltoall", "all-to-all"),
                      ("send", "collective-permute"),
                      ("recv", "collective-permute"),
                      ("permute", "collective-permute")):
        if key in name:
            return kind
    return name


def _tensors(tree) -> list:
    """Every tensor under ``tree``: an op's arguments and outputs, or a
    step's (modules, dataclasses, dicts, lists, tuples)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Trace(TorchDispatchMode):
    """Per-device counts of the ops run under it, on local tensors only
    (see the module's docstring): ``flops``, ``bytes``, ``coll`` (operand
    bytes by kind) and ``counts`` (calls by kind)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake = active_fake_mode()
        self._marked = _propagation_marked()
        self._marked.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._marked.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # its local ops are counted
        out = func(*args, **kwargs)
        if not _PROPAGATING[0] and active_fake_mode() is self._fake:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if outs and not func.is_view and func._opname not in _ALLOCATE \
                and func._opname != "wait_tensor":
            self.bytes += _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
        kind = collective_kind(func)
        if kind is not None:
            operand = args[1] if func._opname in _OUTPUT_FIRST else args[0]
            self.coll[kind] = self.coll.get(kind, 0) + _nbytes(
                _tensors(operand))
            self.counts[kind] = self.counts.get(kind, 0) + 1

    def collective(self) -> dict:
        """The reference's ``collective_bytes`` block."""
        return {"per_kind": dict(self.coll), "counts": dict(self.counts),
                "total": sum(self.coll.values())}


def _storages(tree) -> dict:
    """The distinct local storages under ``tree``'s tensors (a DTensor's
    local shard) → their bytes."""
    from torch.distributed.tensor import DTensor
    out = {}
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


# > 0 while DTensor's sharding propagation runs an op on global-shaped
# fake tensors to learn its output's metadata: in the dry-run's own fake
# mode (``detect_fake_mode``), so a fake-mode test cannot tell those ops
# from the local ones; neither the trace nor the memory tracker counts
# them
_PROPAGATING = [0]


@contextlib.contextmanager
def _propagation_marked():
    """DTensor's propagation marked (``_PROPAGATING``), and a strided
    shard's offsets, which DTensor works out from a small index tensor
    it reads back (``.tolist()``; hazard (z)), worked out on real
    tensors: both are the global shapes' metadata, not the step's
    work."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    run = ShardingPropagator._propagate_tensor_meta_non_cached
    strided = placement_types._StridedShard
    offsets = strided.local_shard_size_and_offset

    def marked(self, op_schema):
        _PROPAGATING[0] += 1
        try:
            return run(self, op_schema)
        finally:
            _PROPAGATING[0] -= 1

    def real_offsets(self, *args, **kwargs):
        with unset_fake_temporarily():
            return offsets(self, *args, **kwargs)
    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    strided.local_shard_size_and_offset = real_offsets
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = run
        strided.local_shard_size_and_offset = offsets


def _mem_tracker():
    """A ``MemTracker`` that leaves DTensor's propagation ops alone."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _PROPAGATING[0]:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return Tracker()


def traced(fn, args: tuple, external: tuple) -> tuple:
    """``fn(*args)`` under ``Trace`` and ``MemTracker`` (``external``:
    the modules and tensors that exist before the step, tracked as its
    arguments).  Returns (the output, the trace, the memory analysis)."""
    mt = _mem_tracker()
    mt.track_external(*_tensors(external))
    arg_bytes = sum(_storages((external, args)).values())
    trace = Trace()
    with trace, mt:
        out = fn(*args)
    peak = max((snap["Total"] for snap in
                mt.get_tracker_snapshot("peak").values()), default=0)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": sum(_storages(out).values()),
           "temp_size_in_bytes": max(peak - arg_bytes, 0),
           "peak_bytes": peak}
    return out, trace, mem


# ---------------------------------------------------------------------------
# The fake process group and the fake CUDA device
# ---------------------------------------------------------------------------


def fake_group(world: int) -> None:
    """Make this process rank 0 of a ``world``-process fake group (one
    already up at another size is replaced).  Refuses where a real group
    is up: the fake one is process-global (hazard (aa))."""
    import torch.distributed as dist

    # registers the "fake" backend (torch's own, in its testing package)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "the dry-run needs this process for its fake process group, "
                f"and a real one ({dist.get_backend()}) is up: run it in a "
                "process of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    # meshes and DTensor's cached plans name the groups of the last one
    _MESHES.clear()
    torch._C._clear_DTensor_sharding_propagator_cache()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)


@functools.cache
def _fake_mode():
    """The process's one ``FakeTensorMode``, shared by its cells."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def fake_cuda_library() -> str:
    """``fake_cuda.cpp`` built with the host compiler against torch's
    headers into build/fake_cuda/ (again where the source is newer);
    returns the library's path."""
    from torch.utils.cpp_extension import include_paths, library_paths
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fake_cuda.cpp")
    out_dir = os.path.join(_ROOT, "build", "fake_cuda")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libfake_cuda.so")
    if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(
            src):
        tmp = f"{lib}.{os.getpid()}"
        abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
        subprocess.run(
            [os.environ.get("CXX", "c++"), "-O1", "-std=c++17", "-shared",
             "-fPIC", f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
             *(f"-I{p}" for p in include_paths()), "-o", tmp, src,
             *(f"-L{p}" for p in library_paths()), "-lc10", "-ltorch_cpu",
             *(f"-Wl,-rpath,{p}" for p in library_paths())],
            check=True, capture_output=True)
        os.replace(tmp, lib)
    return lib


def fake_cuda_env(env: dict | None = None) -> dict:
    """``env`` (default: this process's) with ``fake_cuda_library``
    preloaded: a process started with it traces fake CUDA tensors on a
    torch build without CUDA."""
    env = dict(os.environ if env is None else env)
    env["LD_PRELOAD"] = " ".join(
        p for p in (fake_cuda_library(), env.get("LD_PRELOAD")) if p)
    return env


def fake_cuda_active() -> bool:
    """Whether this process has ``fake_cuda.cpp``'s device: no CUDA, and
    yet CUDA is torch's accelerator."""
    acc = torch.accelerator.current_accelerator()
    return (not torch.cuda.is_available() and acc is not None
            and acc.type == "cuda")


def _device(device: str) -> torch.device:
    """The traced tensors' device: the CPU, or CUDA device 0 (``cuda:0``,
    as ``sharding.mesh_device`` places a fake mesh's tensors)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available() and not fake_cuda_active():
        raise RuntimeError(
            "fake CUDA tensors on a torch build without CUDA need "
            "launch/fake_cuda.cpp preloaded: start the process with "
            "dryrun.fake_cuda_env() (the CLI restarts itself so)")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

# Named sharding-rule experiments for §Perf hillclimbing. Values
# override sharding.LOGICAL_RULES for the duration of one cell.
RULESETS: dict[str, dict] = {
    # Small models: give the model axis to the batch (pure DP-256),
    # ZeRO-3 everything over both axes. Kills the unsharded-attention
    # blowup when n_heads doesn't divide the model axis. Axis order
    # (data, model, pod): batch 256 = data×model exactly on both
    # meshes; pod (multi-pod) goes to ZeRO instead.
    "dp_all": {"batch": ("data", "model", "pod"), "model": (),
               "expert": (), "fsdp": ("pod", "data", "model"),
               "moe_fsdp": ("pod", "data", "model")},
    # Big MoE: true expert parallelism — expert weights sharded over
    # (pod, model) and NOT gathered (no ZeRO on expert weights);
    # dispatch buffers shard capacity over data. Dense params keep
    # ZeRO-3 over (pod, data).
    "ep_moe": {"expert": ("pod", "model"), "moe_fsdp": (),
               "moe_cap": ("data",), "fsdp": ("pod", "data")},
    # Small-expert-count MoE (mixtral: 8 experts on a 16-way axis):
    # keep experts whole, TP the per-expert FF dim over model, shard
    # dispatch capacity over data. No ZeRO on expert weights.
    "moe_tp": {"moe_ff": ("model",), "moe_cap": ("data",),
               "moe_fsdp": ()},
    # dp_all + expert-parallel dispatch (combined experiment)
    "dp_all_moe": {"batch": ("pod", "data", "model"), "model": (),
                   "fsdp": ("data", "model"),
                   "expert": ("model",), "moe_fsdp": (),
                   "moe_cap": ("data",)},
}


# Per-arch production defaults (hillclimb winners — EXPERIMENTS §Perf).
# --rules overrides; "baseline" forces the naive GSPMD configuration.
DEFAULT_RULES: dict[str, str | None] = {
    "smollm-360m": "dp_all",      # 15 heads don't divide model=16: TP off
    "whisper-small": "dp_all",    # 12 heads
    "internvl2-1b": "dp_all",     # 14 heads
    "gemma-2b": "dp_all",         # 8 heads
    "mixtral-8x7b": "moe_tp",     # 8 experts: TP the expert FF instead
    "kimi-k2-1t-a32b": "ep_moe",  # 384 experts: EP, never gather weights
}

BIG = ("kimi-k2-1t-a32b", "jamba-1.5-large-398b")


def mesh_name(shape: tuple) -> str:
    return "x".join(str(n) for n in shape)


_MESHES: dict = {}


def _mesh(shape: tuple, device_type: str):
    """The fake group's mesh of ``shape`` (one a shape and device type,
    kept while the group lives)."""
    from torch.distributed.device_mesh import init_device_mesh
    key = (tuple(shape), device_type)
    if key not in _MESHES:
        axes = ("pod", "data", "model")[-len(shape):]
        _MESHES[key] = init_device_mesh(device_type, tuple(shape),
                                        mesh_dim_names=axes)
    return _MESHES[key]


def _placed(tree, sh: dict):
    from repro_torch.runtime.elastic import place_tree
    return place_tree(tree, sh, local=True)


def _cell_inputs(cfg, shape, tcfg, scfg, mesh, dev):
    """The fake inputs of one cell on ``mesh``: (step, its arguments,
    the tensors and modules tracked as arguments, whether it needs
    autograd)."""
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import (TrainState, make_decode_step,
                                           make_prefill_step,
                                           make_train_step)
    gen = torch.Generator().manual_seed(0)
    if shape.kind == "train":
        dtype = (torch.bfloat16 if tcfg.param_dtype == "bfloat16"
                 else torch.float32)
        params = api.init_params(cfg, gen, dtype, "cpu")
        params = _placed(params, state_sharding(params, mesh))
        state = TrainState(params=params, opt=adamw_init(params, tcfg),
                           step=0)
        batch = api.input_specs(cfg, shape, device=dev)
        batch = _placed(batch, batch_sharding(batch, mesh))
        return (make_train_step(cfg, tcfg, scfg), (state, batch),
                (params, [state.opt.m, state.opt.v], batch))
    params = api.init_params(cfg, gen, torch.bfloat16, "cpu")
    params = _placed(params, state_sharding(params, mesh))
    if shape.kind == "prefill":
        batch = api.input_specs(cfg, shape, device=dev)
        batch = _placed(batch, batch_sharding(batch, mesh))
        return make_prefill_step(cfg), (params, batch), (params, batch)
    caches = api.init_decode_caches(cfg, shape.global_batch, shape.seq_len,
                                    torch.bfloat16, "cpu")
    caches = _placed(caches, cache_sharding(caches, mesh))
    io = api.input_specs(cfg, shape, device=dev)
    token = _placed({"token": io["token"]},
                    batch_sharding({"token": io["token"]}, mesh))["token"]
    # the port's decode position is a Python int: the cache's last slot
    return (make_decode_step(cfg), (params, caches, token,
                                    shape.seq_len - 1),
            (params, caches, token))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             fsdp_pod: bool | None = None, rules_name: str | None = None,
             remat: str | None = None, device: str = "cuda", *, cfg=None,
             shape=None, mesh_shape: tuple | None = None,
             opt_state_dtype: str | None = None,
             param_dtype: str | None = None) -> dict:
    """Trace one cell (see the module's docstring) and return the
    reference's result keys where the port has a counterpart.  The
    keywords cut a cell to size (tests, ``chip_smoke.py``): ``cfg``
    replaces ``arch``'s published config, ``shape`` the shape named,
    ``mesh_shape`` the production mesh ((data, model) or (pod, data,
    model)), ``opt_state_dtype`` the reference's rule (int8 for the big
    architectures), ``param_dtype`` TrainConfig's default."""
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import model_flops, roofline_terms

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod
                                      else (16, 16)))
    name = mesh_name(mesh_shape)
    if shape_name == "long_500k" and not cfg.is_subquadratic():
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "skipped":
                "full-attention arch; long_500k needs sub-quadratic "
                "attention (DESIGN.md §5)"}
    dev = _device(device)

    big = cfg.name in BIG
    fsdp_pod = big if fsdp_pod is None else fsdp_pod
    tcfg = TrainConfig(global_batch=shape.global_batch,
                       seq_len=shape.seq_len,
                       opt_state_dtype=opt_state_dtype or (
                           "int8" if big else "float32"),
                       **({"param_dtype": param_dtype} if param_dtype
                          else {}))
    scfg = ShardingConfig(fsdp=True, fsdp_pod=fsdp_pod,
                          remat=remat or "block")
    rules = {}
    if fsdp_pod:
        rules["fsdp"] = ("pod", "data")
    if rules_name is None:
        rules_name = DEFAULT_RULES.get(arch)
    if rules_name and rules_name != "baseline":
        rules.update(RULESETS[rules_name])

    n_chips = math.prod(mesh_shape)
    fake_group(n_chips)
    t0 = clock.now()
    mesh = _mesh(mesh_shape, dev.type)    # real tensors: its rank map
    with _fake_mode(), logical_rules(**rules):
        with mesh_context(mesh):
            step, args, external = _cell_inputs(cfg, shape, tcfg, scfg,
                                                mesh, dev)
            setup_s = clock.now() - t0
            with torch.set_grad_enabled(shape.kind == "train"):
                _, trace, mem = traced(step, args, external)
    trace_s = clock.now() - t0 - setup_s

    flops, nbytes = float(trace.flops), float(trace.bytes)
    coll = trace.collective()
    mf = model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape_name, "mesh": name,
        "n_chips": int(n_chips), "device": dev.type,
        "rules": rules_name or "baseline", "fsdp_pod": bool(fsdp_pod),
        "opt_state_dtype": tcfg.opt_state_dtype,
        "setup_s": round(setup_s, 1), "trace_s": round(trace_s, 1),
        "flops_per_device": flops,
        "bytes_per_device": nbytes,
        "collective_bytes_per_device": float(coll["total"]),
        "collective": coll,
        "roofline": roofline_terms(flops, nbytes, coll["total"]),
        "memory_analysis": mem,
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / flops if flops else None,
    }


def save_result(res: dict, tag: str = "") -> str:
    mesh_dir = res.get("mesh", "16x16") + (f"__{tag}" if tag else "")
    d = os.path.join(RESULTS, mesh_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{res['arch']}__{res['shape']}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return path


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--rules", default=None,
                    choices=list(RULESETS) + ["baseline"])
    ap.add_argument("--remat", default=None,
                    choices=["none", "block", "full"])
    # the reference's --attn: the port's kernels follow the device
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available() \
            and not fake_cuda_active():
        argv = sys.argv[1:] if argv is None else list(argv)
        os.execve(sys.executable, [sys.executable, "-m",
                                   "repro_torch.launch.dryrun", *argv],
                  fake_cuda_env())
    if not args.tag:
        parts = [p for p in (args.rules,
                             args.device if args.device != "cuda" else None,
                             args.remat) if p]
        args.tag = "_".join(parts)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    failed = 0
    for (a, s) in cells:
        mesh_dir = ("2x16x16" if args.multi_pod else "16x16") + \
            (f"__{args.tag}" if args.tag else "")
        out = os.path.join(RESULTS, mesh_dir, f"{a}__{s}.json")
        if args.skip_done and os.path.exists(out):
            print(f"[skip] {a} × {s}")
            continue
        print(f"[cell] {a} × {s} multi_pod={args.multi_pod} "
              f"rules={args.rules} remat={args.remat} device={args.device}",
              flush=True)
        try:
            res = run_cell(a, s, multi_pod=args.multi_pod,
                           rules_name=args.rules, remat=args.remat,
                           device=args.device)
            path = save_result(res, args.tag)
            if "skipped" in res:
                print(f"  -> skipped: {res['skipped']}")
            else:
                r = res["roofline"]
                print(f"  -> ok in {res['trace_s']}s trace | "
                      f"compute {r['compute_s']:.3e}s memory "
                      f"{r['memory_s']:.3e}s coll {r['collective_s']:.3e}s"
                      f" dominant={r['dominant']} ({path})", flush=True)
        except Exception as e:
            failed += 1
            print(f"  -> FAIL {type(e).__name__}: {e}")
            traceback.print_exc()
            save_result({"arch": a, "shape": s,
                         "mesh": "2x16x16" if args.multi_pod else "16x16",
                         "error": f"{type(e).__name__}: {e}"}, args.tag)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
