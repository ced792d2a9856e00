"""The port's LM sharding (``repro_torch.sharding``'s rules,
``launch/mesh.py``, ``launch/dryrun.py``'s three placement helpers,
``optim/compress.py``, ``runtime/elastic.py``) and the dense, encdec
and vlm families trained and served on a mesh against the reference:

* the rules in-process: every parameter of every family's ``reduced()``
  model on (4, 2), (2, 4), (8, 1) and (pod 2, data 2, model 2) — the
  reference under ``use_abstract_mesh``, the port under
  ``mesh_context(AbstractMesh)`` — the port's spec being the
  reference's without the stacked leading ``None``; the same with
  ``logical_rules`` overrides; ``batch_sharding`` / ``state_sharding``
  against the reference's on a ``Mesh`` naming the one CPU device 8
  times; ``cache_sharding`` against the reference's for every family's
  caches there (C10 reproduced); the decode step's sequence-split
  combine against the single-device step, the cache cut into blocks in
  Python; the cache converter's round trip;
* ``int8_compress`` / ``compress_with_feedback`` bit-equal to
  ``repro.optim.compress``, and error feedback's long-run bias
  (``test_optim.py::test_error_feedback_unbiased``);
* one ``gloo`` group of 8 CPU processes (this file run as a script,
  importing only ``repro_torch``; a ``file://`` rendezvous in a
  temporary directory), started once for the module, which runs:
  the reduced smollm train step of ``test_distributed.py:480-499`` on
  (4, 2), (8, 1) and (2, 4) meshes (the last: 4 q heads over 4, the 2
  kv heads whole) with 1 and 2 microbatches — loss within 1e-4 and
  every parameter within 1e-4 of the single-device JAX step, every
  gradient within 1e-4 of its largest; ``compressed_psum`` over the
  data dimension bit-equal to the reference's arithmetic in numpy,
  with the quirk C8 (an all-zero leaf on one process sets every
  process's scale to at least 1.0); ``reshard_state`` (4, 2) → (2, 4)
  bit-equal; a delta store save of a mesh state and
  ``reshard_from_checkpoint`` bit-equal; the reduced smollm's prefill
  and 4 greedy decode steps on (4, 2), (2, 4) and (8, 1) at batch 8 and
  on (4, 2) and (8, 1) at batch 2 (the KV sequence split) against the
  single-device JAX ``api.prefill`` / ``api.decode_step``
  (``tests/torch_mesh_serve.py``); reduced whisper-small (encdec) and
  internvl2-1b (vlm) as the moe family is held in
  ``tests/test_torch_expert_parallel.py``: one train step from the
  single-device JAX state on (4, 2), (2, 4) and (8, 1) with 1
  microbatch and on (4, 2) with 2, plus an odd vocabulary of 511 (the
  tied table then never splits over ``model``, as at the published
  51865 / 151655) on (4, 2) and, for internvl2 at its published 14 q /
  2 kv heads, on (2, 4) too — loss and every parameter within 1e-4,
  every gradient within 1e-4 of its largest (the learned positions,
  the float32-promoted encoder, ``patch_proj``); their prefill and 4
  greedy steps on the five serving cases (frames, or patches before the
  tokens; whisper's cross caches at the batch rule); the mesh gate
  passed by the encdec and vlm families (the moe, ssm and hybrid
  families train and serve on a mesh in
  ``tests/test_torch_expert_parallel.py``); the int8 optimizer state:
  reduced smollm-360m (two groups, so a stacked leaf's absmax spans
  shards and slices), 2 int8 steps on (4, 2) and on (2, 4), each held to
  the single-device JAX step from the same state under
  ``tests/test_torch_optim.py``'s int8 rule (``torch_int8_mesh``: loss,
  every gradient, every parameter, every ``q`` and ``scale``), each
  ``q`` at its parameter's placement and each ``scale`` replicated; the
  int8 state resharded (4, 2) → (2, 4), and saved from (4, 2) through a
  delta store and restored onto (2, 4), bit for bit; fake against real:
  rank 0 counts the (4, 2) train step and one bf16 decode step with the
  dry-run's ``Trace`` and ``MemTracker`` (``launch.dryrun.traced``), and
  a process of its own traces the same steps on the same mesh on fake
  tensors (``run_cell`` on the fake process group): equal flops, equal
  collective counts and bytes by kind, equal argument bytes and peak;
* in process, the decode step's cross-attention on a mesh: each model
  shard's q heads against its own kv heads of the whole cross caches,
  joined, against the single-device step.
"""
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

WORLD = 8
MESHES = {"4x2": (4, 2), "8x1": (8, 1), "2x4": (2, 4)}
MICROBATCHES = (1, 2)
# test_distributed.py:480-499
TINY = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=128)
BATCH, SEQ, LR = 8, 32, 1e-3
# the group's step counted against its fake trace: (mesh, microbatches)
REAL_STEP = ("4x2", 1)
# compressed_psum: leaf "b" is all zero on this process (C8)
ZERO_RANK = 3
NON_DENSE = {"encdec": "whisper-small", "vlm": "internvl2-1b"}
# the encdec and vlm families in the group: model → (arch, reduced()'s
# overrides).  The published vocabularies (51865, 151655) are odd, so
# the tied table never splits over ``model``, where reduced()'s 512
# does: each family has an odd-vocabulary model; internvl2's also has
# the published 14 q / 2 kv heads (7 : 1 over a model axis of 2, whole
# over 4, where 14 · 32 rows of wo do split)
FAMILY_MODELS = {
    "whisper-small": ("whisper-small", {}),
    "whisper-small-odd": ("whisper-small", dict(vocab=511)),
    "internvl2-1b": ("internvl2-1b", {}),
    "internvl2-1b-odd": ("internvl2-1b", dict(vocab=511, n_heads=14,
                                              n_kv_heads=2)),
}
# model → its (mesh, microbatches) train steps: the reduced models on
# test_torch_expert_parallel.py's STEPS, the odd ones at one microbatch
FAMILY_STEPS = {
    "whisper-small": (("4x2", 1), ("2x4", 1), ("8x1", 1), ("4x2", 2)),
    "whisper-small-odd": (("4x2", 1),),
    "internvl2-1b": (("4x2", 1), ("2x4", 1), ("8x1", 1), ("4x2", 2)),
    "internvl2-1b-odd": (("4x2", 1), ("2x4", 1)),
}
# the models served on the group's serving cases
FAMILY_SERVED = ("whisper-small", "internvl2-1b")
GROUP_TIMEOUT_S = 720
# the int8 optimizer state's steps (tests/torch_int8_mesh.py)
INT8_MESHES = ("4x2", "2x4")


def stub_key(cfg) -> str | None:
    """The batch key of ``cfg``'s modality stub."""
    return {"encdec": "frames", "vlm": "patches"}.get(cfg.family)


def family_config(model: str, reduced, get_config):
    """``FAMILY_MODELS[model]``'s config (the package's ``reduced`` and
    ``get_config`` given: the port's or the reference's)."""
    arch, over = FAMILY_MODELS[model]
    return reduced(get_config(arch), **over)


def _train_config(mb: int, TrainConfig):
    return TrainConfig(global_batch=BATCH, seq_len=SEQ, lr=LR,
                       param_dtype="float32", microbatches=mb)


def psum_inputs(rank: int) -> tuple[dict, dict]:
    """A process's gradients and error feedback for ``compressed_psum``."""
    rng = np.random.default_rng(100 + rank)
    g = {"a": rng.standard_normal(33).astype(np.float32) * 3,
         "b": (rng.standard_normal((5, 4)) * 0.01).astype(np.float32),
         "c": (rng.standard_normal((2, 3, 4)) * 1e-3).astype(np.float32)}
    e = {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
         for k, v in g.items()}
    if rank == ZERO_RANK:
        g["b"] = np.zeros_like(g["b"])
        e["b"] = np.zeros_like(e["b"])
    return g, e


def _worker_checks(rank: int, out: str) -> dict:
    """Every check of the group on this process; rank 0 writes the
    results the tests read (a ``compressed_psum`` result per rank)."""
    import torch

    from repro_torch.checkpoint import DeltaCheckpointStore, io
    from repro_torch.config import ShardingConfig, TrainConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import (batch_sharding, cache_sharding,
                                           state_sharding, traced)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import api
    from repro_torch.optim import compressed_psum
    from repro_torch.runtime import (init_train_state, make_decode_step,
                                     make_grad_fn, make_train_step,
                                     reshard_from_checkpoint, reshard_state)
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import mesh_context
    from torch_mesh_serve import serve_cases

    cfg = reduced(get_config("smollm-360m"), **TINY)
    arrays = np.load(os.path.join(out, "batch.npz"))
    batch = {k: torch.from_numpy(arrays[k]) for k in ("tokens", "labels")}

    def initial(mb: int):
        tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, lr=LR,
                           param_dtype="float32", microbatches=mb)
        return tcfg, io.load_into(init_train_state(cfg, tcfg, device="cpu"),
                                  os.path.join(out, "init.npz"))

    res: dict = {"steps": {}}
    meshes = {name: make_test_mesh(*shape, device_type="cpu")
              for name, shape in MESHES.items()}
    for name, mesh in meshes.items():
        for mb in MICROBATCHES:
            tcfg, state = initial(mb)
            on_mesh = reshard_state(state, mesh)
            placed = place_tree(batch, batch_sharding(batch, mesh))
            with mesh_context(mesh):
                _, grads = make_grad_fn(cfg, tcfg, ShardingConfig())(
                    on_mesh.params, placed)
                grads = io.raw_arrays(grads)
                step = make_train_step(cfg, tcfg, ShardingConfig())
                if rank == 0 and (name, mb) == REAL_STEP:
                    (after, m), trace, mem = traced(step, (on_mesh, placed),
                                                    (on_mesh, placed))
                    res["real"] = {"train": counted(trace, mem)}
                else:
                    after, m = step(on_mesh, placed)
            arrs = io.raw_arrays(after)
            if rank == 0:
                np.savez(os.path.join(out, f"step_{name}_{mb}.npz"),
                         **{f"grad/{k}": v for k, v in grads.items()},
                         **{f"state/{k}": v for k, v in arrs.items()})
            res["steps"][f"{name}_{mb}"] = float(m["loss"])

    g, e = psum_inputs(rank)
    with mesh_context(meshes["4x2"]):
        tot, new_e = compressed_psum(
            {k: torch.from_numpy(v) for k, v in g.items()},
            {k: torch.from_numpy(v) for k, v in e.items()}, "data")
    np.savez(os.path.join(out, f"psum_{rank}.npz"),
             **{f"out/{k}": v.numpy() for k, v in tot.items()},
             **{f"err/{k}": v.numpy() for k, v in new_e.items()})

    tcfg, state = initial(1)
    want = io.raw_arrays(state)
    a = reshard_state(state, meshes["4x2"])
    b = reshard_state(a, meshes["2x4"])
    wanted = state_sharding(state, meshes["2x4"])
    res["reshard_differing"] = sorted(
        k for k, v in io.raw_arrays(b).items()
        if v.tobytes() != want[k].tobytes())
    res["reshard_misplaced"] = sorted(
        n for n, leaf in io.leaves(b) if isinstance(leaf, torch.Tensor)
        and tuple(leaf.placements) != wanted[n].placements)

    with mesh_context(meshes["4x2"]):
        a, _ = make_train_step(cfg, tcfg, ShardingConfig())(
            a, place_tree(batch, batch_sharding(batch, meshes["4x2"])))
    saved = io.raw_arrays(a)
    store = DeltaCheckpointStore(os.path.join(out, f"ckpt_{rank}"))
    store.save(1, a)
    restored = reshard_from_checkpoint(store, 1, initial(1)[1],
                                       meshes["2x4"])
    res["restore_differing"] = sorted(
        k for k, v in io.raw_arrays(restored).items()
        if v.tobytes() != saved[k].tobytes())
    res["restore_on_mesh"] = all(
        leaf.device_mesh == meshes["2x4"]
        for _, leaf in io.leaves(restored.params))

    res["serve"] = serve_cases(initial(1)[1].params,
                               {"tokens": batch["tokens"]}, cfg, meshes, out,
                               "dense", rank)
    res["families"] = _family_checks(rank, out, meshes)

    # the fake trace's decode cell (run_cell): bf16 parameters and caches
    # of the reduced model, the token at the cache's last slot; counted
    mesh = meshes[REAL_STEP[0]]
    dec = api.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.bfloat16, "cpu")
    dec = place_tree(dec, state_sharding(dec, mesh))
    caches = api.init_decode_caches(cfg, BATCH, SEQ, torch.bfloat16, "cpu")
    caches = place_tree(caches, cache_sharding(caches, mesh))
    token = torch.zeros((BATCH, 1), dtype=torch.int32)
    token = place_tree({"token": token},
                       batch_sharding({"token": token}, mesh))["token"]
    with mesh_context(mesh), torch.no_grad():
        args = (dec, caches, token, SEQ - 1)
        if rank == 0:
            _, trace, mem = traced(make_decode_step(cfg), args,
                                   (dec, caches, token))
            res["real"]["decode"] = counted(trace, mem)
        else:
            make_decode_step(cfg)(*args)

    res["raises"] = {"prefill": {}, "decode": {}}
    with mesh_context(meshes["4x2"]):
        for family, arch in NON_DENSE.items():
            c = reduced(get_config(arch))
            res["raises"][family] = raised(lambda: api.check_lm_mesh(c))
            res["raises"]["prefill"][family] = raised(
                lambda: api.check_lm_mesh(c, "prefill"))
            res["raises"]["decode"][family] = raised(
                lambda: api.check_lm_mesh(c, "decode"))
    res["int8"] = _int8_checks(rank, out, meshes)
    return res


def raised(fn):
    try:
        fn()
        return None
    except NotImplementedError as exc:
        return str(exc)


def counted(trace, mem: dict) -> dict:
    """What the fake trace is held to: flops, collectives by kind,
    memory."""
    return {"flops": trace.flops, "collective": trace.collective(),
            "memory": mem}


def _int8_checks(rank: int, out: str, meshes: dict) -> dict:
    """The int8 state on a mesh: ``torch_int8_mesh.int8_steps`` on
    ``INT8_MESHES``; the state resharded (4, 2) → (2, 4); a state after
    an int8 step on (4, 2) saved through a delta store and restored onto
    (2, 4)."""
    import torch

    from repro_torch.checkpoint import DeltaCheckpointStore, io
    from repro_torch.config import ShardingConfig, TrainConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import batch_sharding, state_sharding
    from repro_torch.runtime import (init_train_state, make_train_step,
                                     reshard_from_checkpoint, reshard_state)
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import mesh_context
    from torch_int8_mesh import INT8_KW, int8_steps

    cfg = reduced(get_config("smollm-360m"))
    tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, **INT8_KW)
    init = os.path.join(out, "int8_init.npz")
    arrays = np.load(os.path.join(out, "int8_batch.npz"))
    batch = {k: torch.from_numpy(arrays[k]) for k in ("tokens", "labels")}
    res = {"placements": {name: int8_steps(cfg, tcfg, init, batch,
                                           meshes[name], out, name, rank)
                          for name in INT8_MESHES}}

    def start():
        return io.load_into(init_train_state(cfg, tcfg, device="cpu"), init)

    want = io.raw_arrays(start())
    b = reshard_state(reshard_state(start(), meshes["4x2"]), meshes["2x4"])
    wanted = state_sharding(b, meshes["2x4"])
    res["reshard_differing"] = sorted(
        k for k, v in io.raw_arrays(b).items()
        if v.tobytes() != want[k].tobytes())
    res["reshard_misplaced"] = sorted(
        n for n, leaf in io.leaves(b) if isinstance(leaf, torch.Tensor)
        and tuple(leaf.placements) != wanted[n].placements)

    a = reshard_state(start(), meshes["4x2"])
    with mesh_context(meshes["4x2"]):
        a, _ = make_train_step(cfg, tcfg, ShardingConfig())(
            a, place_tree(batch, batch_sharding(batch, meshes["4x2"])))
    saved = io.raw_arrays(a)
    store = DeltaCheckpointStore(os.path.join(out, f"int8_ckpt_{rank}"))
    store.save(1, a)
    restored = reshard_from_checkpoint(store, 1, start(), meshes["2x4"])
    res["restore_differing"] = sorted(
        k for k, v in io.raw_arrays(restored).items()
        if v.tobytes() != saved[k].tobytes())
    res["restore_on_mesh"] = all(
        x.q.device_mesh == meshes["2x4"]
        for mv in (restored.opt.m, restored.opt.v) for x in mv.values())
    return res


def fake_trace(out: str) -> int:
    """The group's counted steps traced on fake tensors: ``run_cell`` of
    the (4, 2) train step (``TINY``'s reduced smollm, float32, the
    baseline rules) and of the bf16 decode step, in this process of its
    own on the fake process group."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.config import ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cfg = reduced(get_config("smollm-360m"), **TINY)
    res = {}
    for kind in ("train", "decode"):
        r = dryrun.run_cell("smollm-360m", "t", device="cpu", cfg=cfg,
                            shape=ShapeConfig("t", SEQ, BATCH, kind),
                            mesh_shape=MESHES[REAL_STEP[0]],
                            rules_name="baseline", param_dtype="float32")
        res[kind] = {"flops": r["flops_per_device"],
                     "collective": r["collective"],
                     "memory": r["memory_analysis"]}
    with open(os.path.join(out, "fake.json"), "w") as f:
        json.dump(res, f)
    return 0


def _family_checks(rank: int, out: str, meshes: dict) -> dict:
    """Every train step of ``FAMILY_STEPS`` and the serving cases of
    ``FAMILY_SERVED`` on this process; rank 0 writes each step's
    gradients (the step's own, read as ``make_train_step`` takes them
    from its ``make_grad_fn``) and parameters, and the served arrays."""
    from unittest import mock

    import torch

    from repro_torch.checkpoint import io
    from repro_torch.config import ShardingConfig, TrainConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import batch_sharding
    from repro_torch.runtime import (init_train_state, make_train_step,
                                     reshard_state, steps)
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import mesh_context
    from torch_mesh_serve import serve_cases

    grads: dict = {}
    make_grad_fn = steps.make_grad_fn

    def recording(*args):
        grad_fn = make_grad_fn(*args)

        def recorded(params, batch):
            loss, g = grad_fn(params, batch)
            grads.clear()
            grads.update(io.raw_arrays(g))
            return loss, g
        return recorded

    def initial(model, mb):
        cfg = family_config(model, reduced, get_config)
        tcfg = _train_config(mb, TrainConfig)
        state = io.load_into(init_train_state(cfg, tcfg, device="cpu"),
                             os.path.join(out, f"{model}_init.npz"))
        arrays = np.load(os.path.join(out, f"{model}_batch.npz"))
        return cfg, tcfg, state, {k: torch.from_numpy(arrays[k])
                                  for k in arrays.files}

    res: dict = {"steps": {}, "serve": {}, "seconds": {}}
    for model, model_steps in FAMILY_STEPS.items():
        t0 = time.perf_counter()
        for name, mb in model_steps:
            cfg, tcfg, state, batch = initial(model, mb)
            mesh = meshes[name]
            placed = place_tree(batch, batch_sharding(batch, mesh))
            with mesh_context(mesh), mock.patch.object(
                    steps, "make_grad_fn", recording):
                after, m = make_train_step(cfg, tcfg, ShardingConfig())(
                    reshard_state(state, mesh), placed)
            params = io.raw_arrays(after.params)
            if rank == 0:
                np.savez(os.path.join(out, f"step_{model}_{name}_{mb}.npz"),
                         **{f"grad/{k}": v for k, v in grads.items()},
                         **{f"params/{k}": v for k, v in params.items()},
                         step=after.step, opt_step=int(after.opt.step))
            res["steps"][f"{model}_{name}_{mb}"] = float(m["loss"])
        res["seconds"][model] = time.perf_counter() - t0
    for model in FAMILY_SERVED:
        t0 = time.perf_counter()
        cfg, _, state, batch = initial(model, 1)
        served = {k: batch[k] for k in ("tokens", stub_key(cfg))}
        res["serve"][model] = serve_cases(state.params, served, cfg, meshes,
                                          out, model, rank)
        res["seconds"][f"serve {model}"] = time.perf_counter() - t0
    return res


def worker(rank: int, out: str) -> int:
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(
                                seconds=GROUP_TIMEOUT_S))
    try:
        res = _worker_checks(rank, out)
        if rank == 0:
            with open(os.path.join(out, "results.json"), "w") as f:
                json.dump(res, f)
        dist.barrier()
        return 0
    except Exception:
        with open(os.path.join(out, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        return 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.exit(worker(int(sys.argv[2]), sys.argv[3]))
if __name__ == "__main__" and sys.argv[1:2] == ["fake"]:
    sys.exit(fake_trace(sys.argv[2]))

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.devices()   # the backend is up before dryrun sets XLA_FLAGS
_xla_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402

if _xla_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro import sharding as jsharding  # noqa: E402
from repro.config import ShardingConfig as JShardingConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.runtime import init_train_state as j_init  # noqa: E402
from repro.runtime import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.config import TrainConfig, reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (lm_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import compress  # noqa: E402
from repro_torch.optim.adamw import STACKED, stack_key  # noqa: E402
from repro_torch.runtime import init_train_state  # noqa: E402
from torch_mesh_serve import (CASES, case_name, check_served,  # noqa: E402
                              jax_serve, port_serve)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The in-process checks and the parent's single-device port runs
    are too small to gain from intra-op threads, and under ``pytest -n``
    a worker's threads spin against the other workers' and the group's
    8 processes: the port runs this file on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RULE_MESHES = {"4x2": ((4, 2), ("data", "model")),
               "2x4": ((2, 4), ("data", "model")),
               "8x1": ((8, 1), ("data", "model")),
               "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# the reference's dry-run rulesets (launch/dryrun.py::RULESETS)
RULESETS = dict(jdryrun.RULESETS)


def _ref_path(path) -> str:
    return jsharding._path_str(path)


def _port_name_to_ref(name: str) -> tuple[str, bool]:
    """A port leaf name → the reference's path, and whether the
    reference stacks it (its spec then has a leading None)."""
    key = stack_key(name)
    return key.replace(".", "/"), key != name


def _abstract(shape_names):
    shape, names = shape_names
    return JAbstractMesh(shape, names), sharding.AbstractMesh(shape, names)


def _ref_specs(tree, jmesh) -> dict:
    with jax.sharding.use_abstract_mesh(jmesh):
        specs = jsharding.param_specs(tree)
    return {_ref_path(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _ref_shapes(arch):
    jcfg = j_reduced(j_get_config(arch))
    return jcfg, jax.eval_shape(
        lambda: japi.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32))


# ---------------------------------------------------------------------------
# The rules, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ruleset", [None] + sorted(RULESETS))
@pytest.mark.parametrize("mesh", sorted(RULE_MESHES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_specs_match_reference(arch, mesh, ruleset):
    """Every parameter's spec: ``param_spec_for`` on the reference's own
    (stacked) paths and shapes, and ``param_specs`` of the port's model
    on its names — the reference's spec without the leading stacked
    ``None``."""
    jcfg, shapes = _ref_shapes(arch)
    jmesh, pmesh = _abstract(RULE_MESHES[mesh])
    over = RULESETS.get(ruleset, {})
    with jsharding.logical_rules(**over), sharding.logical_rules(**over):
        want = _ref_specs(shapes, jmesh)
        leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
        with sharding.mesh_context(pmesh):
            for path, leaf in leaves:
                p = _ref_path(path)
                assert sharding.param_spec_for(p, leaf.shape) == want[p], p
        model = api.init_params(reduced(get_config(arch)),
                                torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
        with sharding.mesh_context(pmesh):
            got = sharding.param_specs(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, s in got.items():
        ref, stacked = _port_name_to_ref(name)
        assert s == (want[ref][1:] if stacked else want[ref]), (name, s)


def test_port_names_cover_the_stacked_prefixes():
    assert STACKED == ("groups", "enc", "dec")
    assert _port_name_to_ref("groups.3.l0.attn.wq") == (
        "groups/l0/attn/wq", True)
    assert _port_name_to_ref("embed.tok") == ("embed/tok", False)


@pytest.mark.parametrize("mesh", sorted(RULE_MESHES))
def test_spec_resolution_matches_reference(mesh):
    """``resolve`` / ``spec``: presence, divisibility, axes used once,
    composite axes — and the reference's drop to None off a mesh."""
    jmesh, pmesh = _abstract(RULE_MESHES[mesh])
    cases = [(("batch", None), (8, 3)), (("batch", None), (6, 3)),
             (("batch", "fsdp"), (16, 16)), (("model", "fsdp"), (12, 8)),
             (("kv_seq", "batch"), (4, 8)), (("none", "model"), (2, 4)),
             (("fsdp_pod", "model"), (8, 2)), (("moe_cap", "expert"), (8, 8))]
    for logical, dims in cases:
        with jax.sharding.use_abstract_mesh(jmesh):
            want = tuple(jsharding.spec(*logical, dims=dims))
            want_nodims = tuple(jsharding.spec(*logical))
        with sharding.mesh_context(pmesh):
            assert sharding.spec(*logical, dims=dims) == want, logical
            assert sharding.spec(*logical) == want_nodims, logical
    assert sharding.spec("batch", "model") == (None, None)
    assert sharding.current_mesh() is None


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = sharding.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, None), mesh) == (Replicate(),) * 3
    assert sharding.placements(("data",), mesh) == (
        Replicate(), Shard(0), Replicate())


def _repeated_mesh(shape_names):
    shape, names = shape_names
    dev = jax.devices()[0]
    return (JMesh(np.array([dev] * int(np.prod(shape))).reshape(shape),
                  names), sharding.AbstractMesh(shape, names))


@pytest.mark.parametrize("mesh", sorted(RULE_MESHES))
def test_batch_and_state_sharding_match_reference(mesh):
    """``launch.dryrun.batch_sharding`` / ``state_sharding`` against the
    reference's on a ``Mesh`` naming the one CPU device 8 times: the
    batch of every family, a TrainState (params, AdamW moments, steps)."""
    jmesh, pmesh = _repeated_mesh(RULE_MESHES[mesh])
    for b in (8, 6, 2):
        batch = {"tokens": np.zeros((b, 32), np.int32),
                 "labels": np.zeros((b, 32), np.int32),
                 "frames": np.zeros((b, 64, 16), np.float32)}
        want = jdryrun.batch_sharding(
            {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in batch.items()}, jmesh)
        got = dryrun.batch_sharding(
            {k: torch.from_numpy(v) for k, v in batch.items()}, pmesh)
        assert {k: s.spec for k, s in got.items()} == {
            k: tuple(s.spec) for k, s in want.items()}
    jcfg = j_reduced(j_get_config("smollm-360m"))
    tcfg = JTrainConfig(param_dtype="float32")
    jstate = jax.eval_shape(
        lambda: j_init(jax.random.PRNGKey(0), jcfg, tcfg))
    want = {_ref_path(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jdryrun.state_sharding(jstate, jmesh))[0]}
    state = init_train_state(reduced(get_config("smollm-360m")),
                             TrainConfig(param_dtype="float32"),
                             device="cpu")
    got = dryrun.state_sharding(state, pmesh)
    mapped = set()
    for name, s in got.items():
        *head, leaf = name.split("/")
        ref, stacked = _port_name_to_ref(leaf)
        ref = "/".join(head + [ref])
        mapped.add(ref)
        assert s.spec == (want[ref][1:] if stacked else want[ref]), (
            name, s.spec)
    assert mapped == set(want)


# (batch, cache length) of the caches whose placement is checked: the
# batch split, and the KV sequence split where the batch does not divide
CACHE_SHAPES = ((8, 40), (2, 24), (6, 40))


@pytest.mark.parametrize("mesh", sorted(RULE_MESHES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_cache_sharding_matches_reference(arch, mesh):
    """``launch.dryrun.cache_sharding`` of the port's per-group caches
    against the reference's function on its stacked caches (on a
    ``Mesh`` naming the one CPU device 8 times), leaf for leaf with the
    group entry dropped: every family's caches (encdec's self / xk /
    xv), C10's ``pos_map`` spec included."""
    jmesh, pmesh = _repeated_mesh(RULE_MESHES[mesh])
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced(get_config(arch))
    for b, n in CACHE_SHAPES:
        jc = jax.eval_shape(lambda: japi.init_decode_caches(jcfg, b, n))
        want = {_ref_path(p): tuple(sh.spec) for p, sh in
                jax.tree_util.tree_flatten_with_path(
                    jdryrun.cache_sharding(jc, jmesh))[0]}
        caches = api.init_decode_caches(cfg, b, n, torch.float32, "cpu")
        got = dryrun.cache_sharding(caches, pmesh)
        n_groups = len(caches)
        assert len(got) == n_groups * len(want)
        for name, sh in got.items():
            g, rel = name.split("/", 1)
            assert int(g) < n_groups
            assert sh.mesh is pmesh
            assert sh.spec == want[rel][1:], (name, b, n, sh.spec)


def test_cache_sharding_reproduces_the_reference_quirks():
    """C10: a ``pos_map`` [cap] splits its cap over the batch axes (the
    reference sets the second stacked entry of every leaf); an encdec
    layer's xk / xv take the batch rule only (their stacked paths have
    no "/" before them); the SSM state's heads go over ``model``."""
    mesh = sharding.AbstractMesh((4, 2), ("data", "model"))
    sh = dryrun.cache_sharding(api.init_decode_caches(
        reduced(get_config("smollm-360m")), 2, 40, torch.float32, "cpu"),
        mesh)
    assert sh["0/l0/pos_map"].spec == ("data",)
    assert sh["0/l0/k"].spec == (None, "data", "model", None)
    sh = dryrun.cache_sharding(api.init_decode_caches(
        reduced(get_config("whisper-small")), 2, 40, torch.float32, "cpu"),
        mesh)
    assert sh["0/xk"].spec == (None, None, None, None)
    assert sh["0/self/k"].spec == (None, "data", "model", None)
    sh = dryrun.cache_sharding(api.init_decode_caches(
        reduced(get_config("mamba2-130m")), 8, 40, torch.float32, "cpu"),
        mesh)
    assert sh["1/l0/state"].spec == ("data", "model", None, None)
    assert sh["1/l0/conv"].spec == ("data", None, None)


@pytest.mark.parametrize("blocks", [2, 4, 8])
@pytest.mark.parametrize("window", [None, 5])
def test_sequence_split_combine_matches_one_device(blocks, window):
    """The decode step's sequence-split attention: the cache cut into
    ``blocks`` blocks of rows in Python, each block's part
    (``block_softmax``) merged by log-sum-exp (``merge_blocks``, the
    all-reduces here a reduction over the stacked blocks) — against the
    single-device ``_sdpa`` over the whole cache.  The cache holds 9
    rows of 24 (a ring slot, then empty rows), so the last blocks hold
    no valid row; an empty cache gives 0, as ``_sdpa`` does."""
    from repro_torch.models import attention as A
    rng = np.random.default_rng(blocks)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 16)).astype(
        np.float32)) for _ in range(2))
    pos = 9
    pmap = torch.full((24,), -1, dtype=torch.int32)
    pmap[:pos + 1] = torch.arange(pos + 1, dtype=torch.int32)
    pmap[0] = 24         # a later position, masked as the future
    qpos = torch.tensor([pos], dtype=torch.int32)
    stacked = {"max": lambda t: t.amax(0, keepdim=True),
               "sum": lambda t: t.sum(0, keepdim=True)}
    for pm in (pmap, torch.full((24,), -1, dtype=torch.int32)):
        mask = A._mask(qpos, pm, True, window)
        want = A._sdpa(q, k, v, mask, 16 ** -0.5)
        rows = 24 // blocks
        parts = [A.block_softmax(q, k[:, i:i + rows], v[:, i:i + rows],
                                 mask[:, i:i + rows], 16 ** -0.5)
                 for i in range(0, 24, rows)]
        assert any(not bool(m.isfinite().any()) for m, _, _ in parts)
        merged = A.merge_blocks(*(torch.stack(t) for t in zip(*parts)),
                                lambda t, op: stacked[op](t))
        got = A._heads_last(merged[0], q)
        assert not bool(got.isnan().any())
        assert float((got - want).abs().max()) <= 1e-6
    assert float(got.abs().max()) == 0.0


def _random_caches(jcfg, b, n, seed):
    """The reference's stacked caches for ``jcfg`` (its default
    bfloat16, float32 SSM states, int32 ``pos_map``s) filled from a
    seed, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: japi.init_decode_caches(jcfg, b, n))

    def fill(leaf):
        if leaf.dtype == jnp.int32:
            return rng.integers(-1, n, leaf.shape).astype(np.int32)
        return np.asarray(jnp.asarray(rng.standard_normal(leaf.shape),
                                      leaf.dtype))
    return jax.tree.map(fill, shapes)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-small",
                                  "mixtral-8x7b"])
def test_cache_conversion_round_trip(arch):
    """``convert.caches_from_numpy`` / ``caches_to_numpy``: the
    reference's stacked caches (KVCache, SSMCache, encdec xk / xv; bf16
    carried bit for bit, given back as float32) to the port's per-group
    dicts and back, and the port's caches there and back."""
    from repro_torch.convert import caches_from_numpy, caches_to_numpy
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMCache
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    ref = _random_caches(jcfg, 2, 24, 5)
    port = caches_from_numpy(ref, device="cpu")
    like = api.init_decode_caches(cfg, 2, 24, torch.float32, "cpu")
    assert len(port) == len(like)
    for got, want in zip(port, like):
        assert set(got) == set(want)
        for name, entry in want.items():
            assert type(got[name]) is type(entry)
            if isinstance(entry, (KVCache, SSMCache)):
                fields = [f for f in ("k", "v", "pos_map", "conv", "state")
                          if hasattr(entry, f)]
                for f in fields:
                    assert getattr(got[name], f).shape == \
                        getattr(entry, f).shape
    back = caches_to_numpy(port)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_ref)
    for path, a in flat_ref:
        key = tuple(jax.tree_util.DictKey(_ref_path([p]))
                    for p in path)
        b = flat_back[key]
        assert b.dtype == (np.float32 if a.dtype.name == "bfloat16"
                           else a.dtype), path
        assert np.array_equal(b, a.astype(b.dtype)), path
    again = caches_from_numpy(back, device="cpu")
    assert caches_to_numpy(again).keys() == back.keys()
    for x, y in zip(jax.tree.leaves(caches_to_numpy(again)),
                    jax.tree.leaves(back)):
        assert x.tobytes() == y.tobytes()
    assert isinstance(again[0], dict) and all(
        isinstance(t, torch.Tensor) for c in again for e in c.values()
        for t in ([e] if isinstance(e, torch.Tensor) else vars(e).values()))


# ---------------------------------------------------------------------------
# int8 compression, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((64,), 1.0), ((7, 5), 1e-3),
                                         ((3, 4, 5), 300.0), ((9,), 0.0)])
def test_int8_compress_is_the_reference_bit_for_bit(shape, scale):
    rng = np.random.default_rng(int(np.prod(shape)))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    e = (rng.standard_normal(shape) * scale * 0.01).astype(np.float32)
    jq, js = jcompress.int8_compress(jnp.asarray(x))
    q, s = compress.int8_compress(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    assert compress.int8_decompress(q, s).numpy().tobytes() == np.asarray(
        jcompress.int8_decompress(jq, js)).tobytes()
    jout = jcompress.compress_with_feedback(jnp.asarray(x), jnp.asarray(e))
    out = compress.compress_with_feedback(torch.from_numpy(x),
                                          torch.from_numpy(e))
    for a, b in zip(out, jout):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_round_half_to_even_as_jnp():
    """The absmax 127 makes the scale exactly 1: the halves round to
    even in both packages."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 127.0], np.float32)
    q, s = compress.int8_compress(torch.from_numpy(x))
    jq, _ = jcompress.int8_compress(jnp.asarray(x))
    assert float(s) == 1.0
    assert q.tolist() == [0, 2, 2, 0, -2, 4, 127]
    assert np.array_equal(q.numpy(), np.asarray(jq))


def test_error_feedback_unbiased():
    """Accumulated compressed grads converge to accumulated true grads
    (error feedback keeps the long-run bias at one quantization step)."""
    rng = np.random.default_rng(3)
    err = torch.zeros((64,), dtype=torch.float32)
    total_true = np.zeros((64,), np.float32)
    total_sent = np.zeros((64,), np.float32)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal((64,)).astype(np.float32))
        q, scale, err = compress.compress_with_feedback(g, err)
        total_true += g.numpy()
        total_sent += compress.int8_decompress(q, scale).numpy()
    resid = np.abs(total_true - total_sent).max()
    assert resid <= float(err.abs().max()) + 1e-5


# ---------------------------------------------------------------------------
# One gloo group of 8 processes
# ---------------------------------------------------------------------------


def _family_inputs(out: str) -> dict:
    """Each of ``FAMILY_MODELS``' JAX config, initial state and batch
    (``SyntheticLM``'s, with its frames or patches), the state and
    batch written for the processes.  Returns {model: (jcfg, cfg,
    jstate, jbatch)}."""
    inputs = {}
    for model in FAMILY_MODELS:
        jcfg = family_config(model, j_reduced, j_get_config)
        cfg = family_config(model, reduced, get_config)
        jbatch = JSyntheticLM(jcfg, BATCH, SEQ, seed=0).batch_at(0)
        jstate = j_init(jax.random.PRNGKey(0), jcfg,
                        _train_config(1, JTrainConfig))
        io.save_pytree(train_state_from_numpy(
            jax.tree.map(np.asarray, jstate), cfg, device="cpu"),
            os.path.join(out, f"{model}_init.npz"))
        np.savez(os.path.join(out, f"{model}_batch.npz"),
                 **{k: np.asarray(v) for k, v in jbatch.items()})
        inputs[model] = (jcfg, cfg, jstate, jbatch)
    return inputs


def _family_references(jcfg, cfg, jstate, jbatch, model: str) -> dict:
    """The single-device JAX steps of ``model`` (by microbatches),
    ``jax.grad`` of the reference ``loss_fn`` and, for a served model,
    the single-device JAX and port serving runs, in the port's form."""
    ref = {}
    for mb in sorted({mb for _, mb in FAMILY_STEPS[model]}):
        s1, m1 = jax.jit(j_make_train_step(
            jcfg, _train_config(mb, JTrainConfig), JShardingConfig()))(
                jstate, jbatch)
        ref[mb] = (float(m1["loss"]), {
            n: p.detach().numpy() for n, p in train_state_from_numpy(
                jax.tree.map(np.asarray, s1), cfg,
                device="cpu").params.named_parameters()})
    jg = jax.grad(lambda p: japi.loss_fn(p, jbatch, jcfg))(jstate.params)
    ref["grads"] = {n: g.detach().numpy() for n, g in lm_from_numpy(
        jax.tree.map(np.asarray, jg), cfg, device="cpu").named_parameters()}
    if model in FAMILY_SERVED:
        keys = ("tokens", stub_key(cfg))
        ref["serve"] = jax_serve(jstate.params,
                                 {k: jbatch[k] for k in keys}, jcfg)
        ref["port_serve"] = port_serve(
            train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu").params,
            {k: torch.from_numpy(np.asarray(jbatch[k])) for k in keys}, cfg)
    return ref


def _jax_setup():
    jcfg = j_reduced(j_get_config("smollm-360m"), **TINY)
    batch = JSyntheticLM(jcfg, BATCH, SEQ, seed=0).batch_at(0)
    jstate = j_init(jax.random.PRNGKey(0), jcfg, JTrainConfig(
        global_batch=BATCH, seq_len=SEQ, lr=LR, param_dtype="float32"))
    return jcfg, batch, jstate


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Start the 8 processes, compute the single-device JAX references
    meanwhile, and wait for the group (``GROUP_TIMEOUT_S``)."""
    out = str(tmp_path_factory.mktemp("gloo"))
    jcfg, jbatch, jstate = _jax_setup()
    cfg = reduced(get_config("smollm-360m"), **TINY)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu")
    io.save_pytree(state, os.path.join(out, "init.npz"))
    np.savez(os.path.join(out, "batch.npz"),
             **{k: np.asarray(jbatch[k]) for k in ("tokens", "labels")})
    families = _family_inputs(out)
    int8 = _int8_inputs(out)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "fake", out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        ref = {}
        for mb in MICROBATCHES:
            tcfg = JTrainConfig(global_batch=BATCH, seq_len=SEQ, lr=LR,
                                param_dtype="float32", microbatches=mb)
            s1, m1 = jax.jit(j_make_train_step(
                jcfg, tcfg, JShardingConfig()))(jstate, jbatch)
            ref[mb] = (float(m1["loss"]), train_state_from_numpy(
                jax.tree.map(np.asarray, s1), cfg, device="cpu"))
        ref["serve"] = jax_serve(jstate.params,
                                 {"tokens": jbatch["tokens"]}, jcfg)
        ref["port_serve"] = port_serve(state.params, {
            "tokens": torch.from_numpy(np.asarray(jbatch["tokens"]))}, cfg)
        jg = jax.grad(lambda p: japi.loss_fn(p, jbatch, jcfg))(jstate.params)
        ref["grads"] = dict(lm_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                                          device="cpu").named_parameters())
        ref["families"] = {model: _family_references(*args, model)
                           for model, args in families.items()}
        ref["int8"] = int8
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                .decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errors = {f: open(os.path.join(out, f)).read() for f in os.listdir(out)
              if f.startswith("error_")}
    results = None
    if os.path.exists(os.path.join(out, "results.json")):
        with open(os.path.join(out, "results.json")) as f:
            results = json.load(f)
    fake = None
    if os.path.exists(os.path.join(out, "fake.json")):
        with open(os.path.join(out, "fake.json")) as f:
            fake = json.load(f)
    return dict(out=out, ref=ref, errors=errors, results=results, fake=fake,
                rcs=[p.returncode for p in procs], logs=logs, cfg=cfg,
                seconds=time.monotonic() - t0)


def _results(group):
    assert not group["errors"] and group["results"] is not None, (
        group["errors"] or group["logs"][0][-4000:])
    assert group["rcs"] == [0] * (WORLD + 1), (group["rcs"],
                                               group["logs"][-1][-4000:])
    return group["results"]


def _int8_inputs(out: str) -> dict:
    """Reduced smollm-360m's JAX int8 initial state and batch, written
    for the processes."""
    from torch_int8_mesh import INT8_KW
    jcfg = j_reduced(j_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    jtcfg = JTrainConfig(global_batch=BATCH, seq_len=SEQ, **INT8_KW)
    jstate = j_init(jax.random.PRNGKey(0), jcfg, jtcfg)
    jbatch = JSyntheticLM(jcfg, BATCH, SEQ, seed=0).batch_at(0)
    io.save_pytree(train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          cfg, device="cpu"),
                   os.path.join(out, "int8_init.npz"))
    np.savez(os.path.join(out, "int8_batch.npz"),
             **{k: np.asarray(jbatch[k]) for k in ("tokens", "labels")})
    return dict(jcfg=jcfg, jtcfg=jtcfg, jstate=jstate, jbatch=jbatch,
                cfg=cfg)


@pytest.mark.parametrize("microbatches", MICROBATCHES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_train_step_on_a_mesh_matches_jax(group, mesh, microbatches):
    """The reference's own bound (test_distributed.py:496-499): loss and
    every parameter within 1e-4 of the single-device JAX step; and every
    gradient within 1e-4 of its largest entry of ``jax.grad``'s."""
    res = _results(group)
    loss, want = group["ref"][microbatches]
    assert abs(res["steps"][f"{mesh}_{microbatches}"] - loss) < 1e-4
    got = np.load(os.path.join(group["out"],
                               f"step_{mesh}_{microbatches}.npz"))
    for n, w in want.params.named_parameters():
        d = float(np.abs(got[f"state/params/{n}"] - w.detach().numpy()).max())
        assert d < 1e-4, (n, d)
    for n, w in group["ref"]["grads"].items():
        w = w.detach().numpy()
        d = float(np.abs(got[f"grad/{n}"] - w).max())
        assert d <= 1e-4 * float(np.abs(w).max()), (n, d)
    assert int(got["state/step"]) == 1 == int(got["state/opt/step"])


def test_compressed_psum_is_the_reference_arithmetic(group):
    """Over the data dimension of (4, 2): the processes of one model
    column sum their int8 gradients against the max of their scales —
    bit for bit the reference's ``compressed_psum`` in numpy.  C8: the
    all-zero leaf on one process takes scale 1.0 there, so the whole
    column quantizes that leaf against 1.0 and sends zeros."""
    _results(group)
    ins = [psum_inputs(r) for r in range(WORLD)]
    got = [np.load(os.path.join(group["out"], f"psum_{r}.npz"))
           for r in range(WORLD)]
    f32 = np.float32
    for r in range(WORLD):
        column = [c for c in range(WORLD) if c % 2 == r % 2]  # same model
        for k in ins[r][0]:
            ges = {c: ins[c][0][k].astype(f32) + ins[c][1][k] for c in column}
            scales = []
            for c in column:
                a = f32(np.abs(ges[c]).max()) / f32(127.0)
                scales.append(a if a > 0 else f32(1.0))
            smax = max(scales)
            gq = {c: np.clip(np.round(ges[c] / smax), -127, 127)
                  .astype(np.int32) for c in column}
            total = sum(gq[c] for c in column)
            out = total.astype(f32) * smax
            new_e = ges[r] - gq[r].astype(f32) * smax
            assert got[r][f"out/{k}"].tobytes() == out.tobytes(), (r, k)
            assert got[r][f"err/{k}"].tobytes() == new_e.tobytes(), (r, k)
            if k == "b" and ZERO_RANK in column:
                assert smax == 1.0 and not out.any()


def test_reshard_state_between_meshes_is_bit_exact(group):
    res = _results(group)
    assert res["reshard_differing"] == []
    assert res["reshard_misplaced"] == []


def test_reshard_from_checkpoint_is_bit_exact(group):
    res = _results(group)
    assert res["restore_differing"] == []
    assert res["restore_on_mesh"]


@pytest.mark.parametrize("case", [case_name(m, b) for m, b in CASES])
def test_prefill_and_decode_on_a_mesh_match_jax(group, case):
    """The reduced dense LM's prefill and 4 greedy decode steps on the
    mesh against the single-device JAX ``api.prefill`` /
    ``api.decode_step`` and against the single-device port
    (``torch_mesh_serve.check_served``)."""
    res = _results(group)
    b = int(case.rsplit("_b", 1)[1])
    got = np.load(os.path.join(group["out"], f"serve_dense_{case}.npz"))
    check_served(got, group["ref"]["serve"][b],
                 group["ref"]["port_serve"][b], res["serve"][case], b)


@pytest.mark.parametrize("step", [f"{model}_{m}_{mb}"
                                  for model, steps in FAMILY_STEPS.items()
                                  for m, mb in steps])
def test_family_train_step_on_a_mesh_matches_jax(group, step):
    """The encdec and vlm families' step (``FAMILY_STEPS``) against the
    single-device JAX step, as the dense one is held: loss and every
    parameter within 1e-4, every gradient within 1e-4 of its largest
    entry of ``jax.grad``'s — the learned ``embed.pos``, the encoder
    and ``patch_proj`` among them."""
    res = _results(group)
    model, _, mb = step.rsplit("_", 2)
    mb = int(mb)
    ref = group["ref"]["families"][model]
    loss, want = ref[mb]
    assert abs(res["families"]["steps"][step] - loss) < 1e-4
    got = np.load(os.path.join(group["out"], f"step_{step}.npz"))
    assert {k[len("params/"):] for k in got.files
            if k.startswith("params/")} == set(want) == set(ref["grads"])
    for n, w in want.items():
        d = float(np.abs(got[f"params/{n}"] - w).max())
        assert d < 1e-4, (n, d)
    for n, w in ref["grads"].items():
        d = float(np.abs(got[f"grad/{n}"] - w).max())
        assert d <= 1e-4 * float(np.abs(w).max()), (n, d)
    assert int(got["step"]) == 1 == int(got["opt_step"])


@pytest.mark.parametrize("case", [case_name(m, b) for m, b in CASES])
@pytest.mark.parametrize("model", FAMILY_SERVED)
def test_family_prefill_and_decode_on_a_mesh_match_jax(group, model, case):
    """Reduced whisper-small's and internvl2-1b's prefill (over frames,
    or patches before the tokens) and 4 greedy decode steps on the mesh
    against the single-device JAX ``api.prefill`` / ``api.decode_step``
    and the single-device port (``torch_mesh_serve.check_served``):
    every cache leaf, whisper's cross ``xk`` / ``xv`` too, within 1e-4
    of JAX's and at ``cache_sharding``'s placement after each call."""
    res = _results(group)
    b = int(case.rsplit("_b", 1)[1])
    ref = group["ref"]["families"][model]
    got = np.load(os.path.join(group["out"], f"serve_{model}_{case}.npz"))
    if model == "whisper-small":
        assert {"prefill/xk", "last/xv"} <= set(got.files)
    check_served(got, ref["serve"][b], ref["port_serve"][b],
                 res["families"]["serve"][model][case], b)


@pytest.mark.parametrize("what", sorted(NON_DENSE) + ["prefill", "decode"])
def test_what_is_not_ported_raises_on_a_mesh(group, what):
    """encdec and vlm training (by family), their prefill and their
    decode pass the mesh gate (``api.check_lm_mesh``: every family runs
    on a mesh, held above)."""
    res = _results(group)
    got = res["raises"][what]
    msgs = got.values() if isinstance(got, dict) else [got]
    if isinstance(got, dict):
        assert set(got) == set(NON_DENSE)
    for msg in msgs:
        assert msg is None, (what, msg)


@pytest.mark.parametrize("mesh", INT8_MESHES)
def test_int8_steps_on_a_mesh_match_jax(group, mesh):
    """Reduced smollm-360m, 2 int8 steps on the mesh, each held to the
    single-device JAX step from the same state under
    ``test_torch_optim.py``'s int8 rule (``torch_int8_mesh``): the loss
    and every gradient within the group's 1e-4, the reference's
    ``adamw_update`` on the step's gradients giving every ``q`` and
    ``scale`` bit for bit and every parameter within 1e-6; each ``q`` at
    its parameter's placement, each ``scale`` replicated."""
    from torch_int8_mesh import check_int8_steps
    res = _results(group)
    facts = res["int8"]["placements"][mesh]
    assert facts == {"q_as_param": True, "scale_replicated": True,
                     "q_int8": True}, facts
    r = group["ref"]["int8"]
    check_int8_steps(group["out"], mesh, r["jcfg"], r["jtcfg"], r["jstate"],
                     r["jbatch"], r["cfg"])


def test_int8_state_reshards_between_meshes_bit_exact(group):
    res = _results(group)["int8"]
    assert res["reshard_differing"] == []
    assert res["reshard_misplaced"] == []


def test_int8_state_checkpoint_round_trip_from_a_mesh(group):
    """An int8 state after a step on (4, 2), saved through a delta store
    and restored onto (2, 4): every q, scale and parameter bit-equal."""
    res = _results(group)["int8"]
    assert res["restore_differing"] == []
    assert res["restore_on_mesh"]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_fake_trace_counts_as_the_real_step(group, kind):
    """Rank 0's count of the group's (4, 2) train step and of a bf16
    decode step (``launch.dryrun.traced`` on real tensors over ``gloo``)
    against the dry-run's trace of the same step on the same mesh on
    fake tensors (``run_cell``): equal flops, equal collective counts and
    operand bytes by kind (DTensor's functional collectives and the
    in-place ``dist.all_reduce`` calls both, hazard (y)), equal argument
    bytes and peak."""
    real = _results(group)["real"][kind]
    fake = group["fake"][kind]
    assert fake is not None
    assert real["flops"] == fake["flops"] > 0
    assert real["collective"] == fake["collective"]
    assert real["collective"]["total"] > 0
    assert real["memory"] == fake["memory"], (real["memory"],
                                               fake["memory"])


# ---------------------------------------------------------------------------
# The decode step's cross-attention on a mesh, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_cross_decode_on_split_q_heads_matches_one_device(mesh):
    """``attention.cross_decode`` on a mesh: q [B, 1, Hq 4, hd] placed by
    the reference's spec, the cross caches [B, S_enc, Hkv 2, hd] at
    ``batch_cache_spec``'s (heads and rows whole).  Each process's local
    step — its q heads, ``own_kv_heads`` of the whole caches, every row
    attended — run here for every model shard of the abstract mesh in
    turn and the shards joined, against the single-device step (GQA, no
    mask)."""
    from repro_torch.models import attention as A
    shape, names = RULE_MESHES[mesh]
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((8, 1, 4, 16)).astype(
        np.float32))
    xk, xv = (torch.from_numpy(rng.standard_normal((8, 24, 2, 16)).astype(
        np.float32)) for _ in range(2))
    scale = 16 ** -0.5
    want = A.cross_decode(q, xk, xv, scale)
    with sharding.mesh_context(sharding.AbstractMesh(shape, names)):
        sq = sharding.spec("batch", None, "model", None, dims=q.shape)
        skv = sharding.batch_cache_spec(tuple(xk.shape))
    n_model = dict(zip(names, shape))["model"]
    assert sq == ("data", None, "model", None)
    assert skv == ("data", None, None, None)
    n = 4 // n_model
    parts = []
    for j in range(n_model):
        kl, vl = A.own_kv_heads(xk, xv, j * n, n, 2)
        assert kl.shape[2] == n
        parts.append(A._attend_all(q[:, :, j * n:(j + 1) * n], kl, vl,
                                   scale))
    got = torch.cat(parts, dim=2)
    assert float((got - want).abs().max()) <= 1e-6
    assert float((want - A._sdpa(q, xk, xv, torch.ones(
        (1, 24), dtype=torch.bool), scale)).abs().max()) == 0.0
