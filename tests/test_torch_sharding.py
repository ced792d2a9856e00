"""The port's LM sharding (``repro_torch.sharding``'s rules,
``launch/mesh.py``, ``launch/dryrun.py``'s two placement helpers,
``optim/compress.py``, ``runtime/elastic.py``) against the reference:

* the rules in-process: every parameter of every family's ``reduced()``
  model on (4, 2), (2, 4), (8, 1) and (pod 2, data 2, model 2) — the
  reference under ``use_abstract_mesh``, the port under
  ``mesh_context(AbstractMesh)`` — the port's spec being the
  reference's without the stacked leading ``None``; the same with
  ``logical_rules`` overrides; ``batch_sharding`` / ``state_sharding``
  against the reference's on a ``Mesh`` naming the one CPU device 8
  times;
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
  ``reshard_from_checkpoint`` bit-equal; the encdec and vlm families'
  training, prefill and decode, and the int8 optimizer state raising
  ``not_ported`` with "A17" on a mesh (the moe, ssm and hybrid families
  train on a mesh in ``tests/test_torch_expert_parallel.py``).
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
# compressed_psum: leaf "b" is all zero on this process (C8)
ZERO_RANK = 3
NON_DENSE = {"encdec": "whisper-small", "vlm": "internvl2-1b"}
GROUP_TIMEOUT_S = 240


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
    from repro_torch.launch.dryrun import batch_sharding, state_sharding
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import api
    from repro_torch.optim import adamw_update, compressed_psum
    from repro_torch.runtime import (init_train_state, make_grad_fn,
                                     make_train_step, reshard_from_checkpoint,
                                     reshard_state)
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import mesh_context

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
                after, m = make_train_step(cfg, tcfg, ShardingConfig())(
                    on_mesh, placed)
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

    res["raises"] = {}
    for family, arch in NON_DENSE.items():
        c = reduced(get_config(arch))
        with mesh_context(meshes["4x2"]):
            try:
                api.loss_fn(None, batch, c)
                res["raises"][family] = None
            except NotImplementedError as exc:
                res["raises"][family] = str(exc)
    with mesh_context(meshes["4x2"]):
        for what, fn in (
                ("prefill", lambda: api.prefill(None, batch, cfg)),
                ("decode", lambda: api.decode_step(
                    None, batch["tokens"][:, :1], 0, None, cfg)),
                ("int8", lambda: adamw_update(
                    {}, None, {}, TrainConfig(opt_state_dtype="int8"), 0.1))):
            try:
                fn()
                res["raises"][what] = None
            except NotImplementedError as exc:
                res["raises"][what] = str(exc)
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


def test_dryrun_itself_waits_for_its_step():
    with pytest.raises(NotImplementedError, match="A18"):
        dryrun.run_cell()
    with pytest.raises(NotImplementedError, match="A18"):
        dryrun.main([])
    with pytest.raises(NotImplementedError, match="A17"):
        dryrun.cache_sharding({}, None)


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
    io.save_pytree(train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          cfg, device="cpu"),
                   os.path.join(out, "init.npz"))
    np.savez(os.path.join(out, "batch.npz"),
             **{k: np.asarray(jbatch[k]) for k in ("tokens", "labels")})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        ref = {}
        for mb in MICROBATCHES:
            tcfg = JTrainConfig(global_batch=BATCH, seq_len=SEQ, lr=LR,
                                param_dtype="float32", microbatches=mb)
            s1, m1 = jax.jit(j_make_train_step(
                jcfg, tcfg, JShardingConfig()))(jstate, jbatch)
            ref[mb] = (float(m1["loss"]), train_state_from_numpy(
                jax.tree.map(np.asarray, s1), cfg, device="cpu"))
        jg = jax.grad(lambda p: japi.loss_fn(p, jbatch, jcfg))(jstate.params)
        ref["grads"] = dict(lm_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                                          device="cpu").named_parameters())
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
    return dict(out=out, ref=ref, errors=errors, results=results,
                rcs=[p.returncode for p in procs], logs=logs, cfg=cfg)


def _results(group):
    assert not group["errors"] and group["results"] is not None, (
        group["errors"] or group["logs"][0][-4000:])
    assert group["rcs"] == [0] * WORLD, group["rcs"]
    return group["results"]


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


@pytest.mark.parametrize("what", sorted(NON_DENSE)
                         + ["prefill", "decode", "int8"])
def test_what_is_not_ported_raises_on_a_mesh(group, what):
    res = _results(group)
    assert res["raises"][what] is not None, what
    assert "A17" in res["raises"][what]
