"""Expert parallelism (``repro_torch.models.moe.apply_moe_sharded``) and
the moe, ssm and hybrid families training on a ``DeviceMesh``, against
the JAX package:

* in process, the shard-local MoE body ``moe.moe_partial`` against the
  reference's own ``_local_moe`` run under ``jax.vmap(...,
  axis_name="model")`` over the ``ep`` shards of the expert weights
  (its ``psum`` then sums the shards), the tokens cut into ``dp``
  shards in Python — the reference's ``shard_map`` test cannot run here
  (ROADMAP C3).  Reduced mixtral-8x7b (4 experts, top-2) and kimi-k2
  (16 experts, top-8) at ep 1 / 2 / 4 × dp 1 / 2, at capacity factor
  8.0 (nothing drops) and 1.25 with skewed tokens (pairs drop, and the
  capacity is that of the local tokens: ROADMAP hazard (s)).  The port's
  parts of a dp shard are summed in Python.  Routing integers (top-k,
  sorted order, keep, this shard's keep and slot) equal to the
  reference's own lines (``repro/models/moe.py:124-158``), outputs
  within ``test_torch_moe.py``'s ``F32_TOL``, and the gradients of x,
  wg, w_up, w_gate and w_down within ``GRAD_REL`` of the largest entry
  of ``jax.grad``'s through the vmapped oracle;
* the mesh gate (``models.api.check_lm_mesh``) for every architecture:
  training, prefill and decode of every family pass it (the encdec and
  vlm families run on a mesh in ``tests/test_torch_sharding.py``'s
  group);
* one ``gloo`` group of 8 CPU processes (this file run as a script,
  importing only ``repro_torch``; a ``file://`` rendezvous in a
  temporary directory), started once for the module: one train step of
  reduced mixtral-8x7b, kimi-k2-1t-a32b, mamba2-130m and
  jamba-1.5-large-398b (one period) from the single-device JAX state,
  on the (4, 2), (2, 4) and (8, 1) meshes with 1 microbatch and on
  (4, 2) with 2.  (2, 4) puts one of the 4 experts on each process and
  jamba's 2 kv heads on a model axis of 4 (hazard (p)).  Loss and every
  parameter within the reference's own bounds
  (``test_distributed.py:454-458``: 2e-4 for the moe family;
  ``:496-499``: 1e-4 for ssm and hybrid) of the single-device JAX step,
  and every gradient within 1e-4 of its largest entry of ``jax.grad``'s
  (a missing or doubled sum of the tokens' and the router's gradients
  over the expert axis, hazard (t), moves no loss and no first AdamW
  step beyond those bounds; only the gradients show it); then 2 int8
  steps of reduced mixtral-8x7b on (4, 2), each held to the
  single-device JAX step from the same state under
  ``tests/test_torch_optim.py``'s int8 rule (``torch_int8_mesh``; the
  loss within the moe family's 2e-4).
"""
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

WORLD = 8
MESHES = {"4x2": (4, 2), "2x4": (2, 4), "8x1": (8, 1)}
# (mesh, microbatches) of the group's train steps
STEPS = (("4x2", 1), ("2x4", 1), ("8x1", 1), ("4x2", 2))
# arch → the reference's bound on the loss and the parameters
GROUP_ARCHS = {"mixtral-8x7b": 2e-4, "kimi-k2-1t-a32b": 2e-4,
               "mamba2-130m": 1e-4, "jamba-1.5-large-398b": 1e-4}
GRAD_BOUND = 1e-4
BATCH, SEQ, LR = 8, 32, 1e-3
GROUP_TIMEOUT_S = 600
# the int8 optimizer state on a mesh (tests/torch_int8_mesh.py)
INT8_ARCH, INT8_MESH = "mixtral-8x7b", "4x2"


def _train_kwargs(mb: int) -> dict:
    return dict(global_batch=BATCH, seq_len=SEQ, lr=LR,
                param_dtype="float32", microbatches=mb)


def _worker_checks(rank: int, out: str) -> dict:
    """Every train step of the group on this process; rank 0 writes the
    gradients and the states the tests read.  The gradients are the
    step's own, read as ``make_train_step`` takes them from its
    ``make_grad_fn`` (one forward and backward a step)."""
    from unittest import mock

    import torch

    from repro_torch.checkpoint import io
    from repro_torch.config import ShardingConfig, TrainConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import batch_sharding
    from repro_torch.launch.mesh import make_test_mesh
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

    meshes = {name: make_test_mesh(*shape, device_type="cpu")
              for name, shape in MESHES.items()}
    res: dict = {"steps": {}, "seconds": {}, "serve": {},
                 "serve_seconds": {}}
    for arch in GROUP_ARCHS:
        t0 = time.perf_counter()
        cfg = reduced(get_config(arch))
        arrays = np.load(os.path.join(out, f"{arch}_batch.npz"))
        batch = {k: torch.from_numpy(arrays[k]) for k in ("tokens", "labels")}
        for name, mb in STEPS:
            tcfg = TrainConfig(**_train_kwargs(mb))
            state = io.load_into(init_train_state(cfg, tcfg, device="cpu"),
                                 os.path.join(out, f"{arch}_init.npz"))
            mesh = meshes[name]
            on_mesh = reshard_state(state, mesh)
            placed = place_tree(batch, batch_sharding(batch, mesh))
            with mesh_context(mesh), mock.patch.object(
                    steps, "make_grad_fn", recording):
                after, m = make_train_step(cfg, tcfg, ShardingConfig())(
                    on_mesh, placed)
            params = io.raw_arrays(after.params)
            if rank == 0:
                np.savez(os.path.join(out, f"step_{arch}_{name}_{mb}.npz"),
                         **{f"grad/{k}": v for k, v in grads.items()},
                         **{f"params/{k}": v for k, v in params.items()},
                         step=after.step, opt_step=int(after.opt.step))
            res["steps"][f"{arch}_{name}_{mb}"] = float(m["loss"])
        res["seconds"][arch] = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = io.load_into(init_train_state(
            cfg, TrainConfig(**_train_kwargs(1)), device="cpu"),
            os.path.join(out, f"{arch}_init.npz")).params
        res["serve"][arch] = serve_cases(
            params, {"tokens": batch["tokens"]}, cfg, meshes, out, arch,
            rank)
        res["serve_seconds"][arch] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from torch_int8_mesh import INT8_KW, int8_steps
    arrays = np.load(os.path.join(out, f"{INT8_ARCH}_batch.npz"))
    res["int8"] = int8_steps(
        reduced(get_config(INT8_ARCH)),
        TrainConfig(global_batch=BATCH, seq_len=SEQ, **INT8_KW),
        os.path.join(out, f"{INT8_ARCH}_int8_init.npz"),
        {k: torch.from_numpy(arrays[k]) for k in ("tokens", "labels")},
        meshes[INT8_MESH], out, INT8_ARCH, rank)
    res["seconds"]["int8"] = time.perf_counter() - t0
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

import functools  # noqa: E402

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ShardingConfig as JShardingConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.runtime import init_train_state as j_init  # noqa: E402
from repro.runtime import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (_tensor, lm_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.models import api, moe  # noqa: E402
from torch_mesh_serve import CASES as SERVE_CASES  # noqa: E402
from torch_mesh_serve import (case_name, check_served,  # noqa: E402
                              jax_serve, port_serve)

# test_torch_moe.py's cases and tolerances
CASES = {"mixtral": ("mixtral-8x7b", {}),
         "kimi-k8": ("kimi-k2-1t-a32b", dict(n_experts=16, top_k=8))}
F32_TOL = 1e-5
GRAD_REL = 1e-4
# capacity factor → the shared offset of the tokens (test_torch_moe.py's
# ``_x``): 8.0 is the reduced default, where nothing drops; at 1.25 the
# skewed tokens overflow some experts
FACTORS = {8.0: 0.0, 1.25: 1.0}
TOKENS = (4, 64)
MESH_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _configs(case, factor):
    arch, over = CASES[case]
    over = dict(over, capacity_factor=factor)
    return j_reduced(j_get_config(arch), **over), \
        reduced(get_config(arch), **over)


def _x(shape, seed=1, offset=0.0):
    """test_torch_moe.py's seeded activations."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x + offset * rng.standard_normal(shape[-1:]).astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


def _jax_local_route(p, x_loc, cfg, e0, e_loc):
    """The reference's routing of one shard, its own lines
    (``_local_moe``, repro/models/moe.py:124-158)."""
    t_loc = x_loc.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = x_loc.astype(jnp.float32) @ p["wg"]
    topv, topi = jax.lax.top_k(logits, k)
    e_flat = topi.reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    seg_start = jnp.searchsorted(e_sorted, jnp.arange(e))
    pos_in_e = jnp.arange(t_loc * k) - seg_start[e_sorted]
    cap = jmoe.capacity(cfg, t_loc)
    keep = pos_in_e < cap
    mine = keep & (e_sorted >= e0) & (e_sorted < e0 + e_loc)
    lslot = jnp.where(mine, (e_sorted - e0) * cap + pos_in_e, e_loc * cap)
    return dict(topi=topi, order=order, keep=keep, mine=mine, slot=lslot,
                cap=cap)


_WEIGHTS = ("wg", "w_up", "w_gate", "w_down")


def _oracle(jcfg, ep: int, dp: int):
    """(x, wg, w_up, w_gate, w_down) → [T, d]: the reference's
    ``_local_moe`` vmapped over ``ep`` shards of the expert weights (its
    ``psum`` over the vmapped axis sums them), on each of ``dp`` token
    shards in turn."""
    e_loc = jcfg.n_experts // ep
    body = jax.vmap(functools.partial(
        jmoe._local_moe, cfg=jcfg, e_loc=e_loc, ep_axes=("model",),
        red_axes=("model",)), in_axes=(None, None, 0, 0, 0),
        axis_name="model")

    def run(x, wg, w_up, w_gate, w_down):
        def split(w):
            return w.reshape(ep, e_loc, *w.shape[1:])
        return jnp.concatenate(
            [body(xl, wg, split(w_up), split(w_gate), split(w_down))[0]
             for xl in jnp.split(x, dp)])
    return run


def _port(cfg, ep: int, dp: int, x, wg, w_up, w_gate, w_down):
    """The port's parts of each dp shard (``moe_partial`` of each ep
    shard's experts) summed in Python, the shards concatenated."""
    e_loc = cfg.n_experts // ep
    outs = []
    for xl in torch.chunk(x, dp):
        part = 0
        for j in range(ep):
            ex = slice(j * e_loc, (j + 1) * e_loc)
            part = part + moe.moe_partial(xl, wg, w_up[ex], w_gate[ex],
                                          w_down[ex], cfg, j * e_loc, e_loc)
        outs.append(part)
    return torch.cat(outs)


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("ep", [1, 2, 4])
@pytest.mark.parametrize("factor", sorted(FACTORS))
@pytest.mark.parametrize("case", list(CASES))
def test_local_moe_matches_the_reference_under_vmap(case, factor, ep, dp):
    jcfg, cfg = _configs(case, factor)
    p = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = _x((TOKENS[0] * TOKENS[1], cfg.d_model), offset=FACTORS[factor])
    ct = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    e_loc = cfg.n_experts // ep

    # the routing of every (dp, ep) shard
    dropped = 0
    for xl in np.split(x, dp):
        for j in range(ep):
            want = _jax_local_route(p, jnp.asarray(xl), jcfg, j * e_loc,
                                    e_loc)
            r = moe.route_by(_tensor(np.asarray(p["wg"])),
                             torch.from_numpy(xl), cfg)
            loc = moe.local_route(r, j * e_loc, e_loc)
            assert r.cap == loc.cap == want["cap"] == moe.capacity(
                cfg, xl.shape[0])
            for name, got in (("topi", r.topi), ("order", r.order),
                              ("keep", r.keep), ("mine", loc.keep),
                              ("slot", loc.slot)):
                assert np.array_equal(got.numpy(), np.asarray(want[name])), \
                    (name, j)
            dropped += int((~r.keep).sum())
    assert (dropped > 0) == (factor < 8.0), dropped

    oracle = _oracle(jcfg, ep, dp)
    jargs = (jnp.asarray(x),) + tuple(p[k] for k in _WEIGHTS)
    want, jgrads = jax.jit(lambda *a: (oracle(*a), jax.grad(
        lambda *b: jnp.sum(oracle(*b) * ct), argnums=tuple(range(5)))(*a)))(
            *jargs)

    targs = [torch.from_numpy(x).requires_grad_()] + [
        _tensor(np.asarray(p[k])).requires_grad_() for k in _WEIGHTS]
    got = _port(cfg, ep, dp, *targs)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert float(np.abs(_np(got) - np.asarray(want)).max()) <= F32_TOL
    (got * torch.from_numpy(ct)).sum().backward()
    for name, t, g in zip(("x",) + _WEIGHTS, targs, jgrads):
        g = np.asarray(g)
        d = float(np.abs(_np(t.grad) - g).max())
        assert d <= GRAD_REL * float(np.abs(g).max()), (name, d)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_the_mesh_gate(arch):
    """Training, prefill and decode pass ``check_lm_mesh`` for every
    family."""
    cfg = reduced(get_config(arch))
    mesh = sharding.AbstractMesh((4, 2), ("data", "model"))
    api.check_lm_mesh(cfg)
    assert cfg.family in MESH_FAMILIES
    assert api.MESH_FAMILIES == MESH_FAMILIES
    with sharding.mesh_context(mesh):
        for what in ("training", "prefill", "decode"):
            api.check_lm_mesh(cfg, what)


# ---------------------------------------------------------------------------
# One gloo group of 8 processes
# ---------------------------------------------------------------------------


def _jax_inputs(arch: str):
    """``arch``'s reduced configs, JAX initial state and batch."""
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jbatch = JSyntheticLM(jcfg, BATCH, SEQ, seed=0).batch_at(0)
    jstate = j_init(jax.random.PRNGKey(0), jcfg,
                    JTrainConfig(**_train_kwargs(1)))
    return jcfg, cfg, jstate, jbatch


def _jax_references(jcfg, cfg, jstate, jbatch) -> dict:
    """The single-device JAX steps (by microbatches) and ``jax.grad`` of
    the reference ``loss_fn``, in the port's form."""
    ref = {}
    for mb in sorted({mb for _, mb in STEPS}):
        s1, m1 = jax.jit(j_make_train_step(
            jcfg, JTrainConfig(**_train_kwargs(mb)), JShardingConfig()))(
                jstate, jbatch)
        ref[mb] = (float(m1["loss"]), train_state_from_numpy(
            jax.tree.map(np.asarray, s1), cfg, device="cpu"))
    ref["serve"] = jax_serve(jstate.params, {"tokens": jbatch["tokens"]},
                             jcfg)
    ref["port_serve"] = port_serve(
        train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                               device="cpu").params,
        {"tokens": torch.from_numpy(np.asarray(jbatch["tokens"]))}, cfg)
    jg = jax.grad(lambda p: japi.loss_fn(p, jbatch, jcfg))(jstate.params)
    ref["grads"] = {n: g.detach().numpy() for n, g in lm_from_numpy(
        jax.tree.map(np.asarray, jg), cfg, device="cpu").named_parameters()}
    return ref


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Write every model's JAX initial state and batch, start the 8
    processes, compute the single-device JAX references meanwhile, and
    wait for the group (``GROUP_TIMEOUT_S``)."""
    out = str(tmp_path_factory.mktemp("gloo_ep"))
    inputs = {arch: _jax_inputs(arch) for arch in GROUP_ARCHS}
    for arch, (_, cfg, jstate, jbatch) in inputs.items():
        io.save_pytree(train_state_from_numpy(
            jax.tree.map(np.asarray, jstate), cfg, device="cpu"),
            os.path.join(out, f"{arch}_init.npz"))
        np.savez(os.path.join(out, f"{arch}_batch.npz"),
                 **{k: np.asarray(jbatch[k]) for k in ("tokens", "labels")})
    int8 = _int8_inputs(out, *inputs[INT8_ARCH][:2])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        ref = {arch: _jax_references(*args) for arch, args in inputs.items()}
        ref["int8"] = int8
        deadline = t0 + GROUP_TIMEOUT_S
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
                rcs=[p.returncode for p in procs], logs=logs,
                seconds=time.monotonic() - t0)


def _results(group):
    assert not group["errors"] and group["results"] is not None, (
        group["errors"] or group["logs"][0][-4000:])
    assert group["rcs"] == [0] * WORLD, group["rcs"]
    return group["results"]


def _int8_inputs(out: str, jcfg, cfg) -> dict:
    """``INT8_ARCH``'s JAX initial state with the int8 optimizer state,
    written for the processes (the batch is the float32 steps')."""
    from torch_int8_mesh import INT8_KW
    jtcfg = JTrainConfig(global_batch=BATCH, seq_len=SEQ, **INT8_KW)
    jstate = j_init(jax.random.PRNGKey(0), jcfg, jtcfg)
    io.save_pytree(train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          cfg, device="cpu"),
                   os.path.join(out, f"{INT8_ARCH}_int8_init.npz"))
    return dict(jcfg=jcfg, jtcfg=jtcfg, jstate=jstate, cfg=cfg)


def test_int8_steps_on_a_mesh_match_jax(group):
    """Reduced mixtral-8x7b, 2 int8 steps on (4, 2) (expert parallel),
    each held to the single-device JAX step from the same state under
    ``test_torch_optim.py``'s int8 rule (``torch_int8_mesh``): loss within
    the moe family's 2e-4, every gradient within 1e-4 of its largest,
    every ``q`` and ``scale`` of the reference's ``adamw_update`` on the
    step's gradients bit for bit, every parameter within 1e-6; each ``q``
    at its parameter's placement, each ``scale`` replicated."""
    from torch_int8_mesh import check_int8_steps
    res = _results(group)
    assert res["int8"] == {"q_as_param": True, "scale_replicated": True,
                           "q_int8": True}, res["int8"]
    r = group["ref"]["int8"]
    jbatch = np.load(os.path.join(group["out"], f"{INT8_ARCH}_batch.npz"))
    check_int8_steps(group["out"], INT8_ARCH, r["jcfg"], r["jtcfg"],
                     r["jstate"], {k: jnp.asarray(jbatch[k])
                                   for k in jbatch.files}, r["cfg"],
                     loss_bound=GROUP_ARCHS[INT8_ARCH])


@pytest.mark.parametrize("case", [case_name(m, b) for m, b in SERVE_CASES])
@pytest.mark.parametrize("arch", list(GROUP_ARCHS))
def test_prefill_and_decode_on_a_mesh_match_jax(group, arch, case):
    """Prefill and 4 greedy decode steps on the mesh against the
    single-device JAX ``api.prefill`` / ``api.decode_step`` and against
    the single-device port (``torch_mesh_serve.check_served``).
    Nothing drops at the reduced capacity factor 8 (each process's local
    tokens, hazard (s), fit), so the single-device oracles hold the MoE
    too."""
    res = _results(group)
    b = int(case.rsplit("_b", 1)[1])
    got = np.load(os.path.join(group["out"], f"serve_{arch}_{case}.npz"))
    check_served(got, group["ref"][arch]["serve"][b],
                 group["ref"][arch]["port_serve"][b],
                 res["serve"][arch][case], b)


@pytest.mark.parametrize("step", [f"{m}_{mb}" for m, mb in STEPS])
@pytest.mark.parametrize("arch", list(GROUP_ARCHS))
def test_train_step_on_a_mesh_matches_jax(group, arch, step):
    """Loss and every parameter within the reference's own bound of the
    single-device JAX step; every gradient within ``GRAD_BOUND`` of its
    largest entry of ``jax.grad``'s."""
    res = _results(group)
    bound = GROUP_ARCHS[arch]
    mb = int(step.rsplit("_", 1)[1])
    loss, want = group["ref"][arch][mb]
    assert abs(res["steps"][f"{arch}_{step}"] - loss) < bound
    got = np.load(os.path.join(group["out"], f"step_{arch}_{step}.npz"))
    for n, w in want.params.named_parameters():
        d = float(np.abs(got[f"params/{n}"] - w.detach().numpy()).max())
        assert d < bound, (n, d)
    for n, w in group["ref"][arch]["grads"].items():
        d = float(np.abs(got[f"grad/{n}"] - w).max())
        assert d <= GRAD_BOUND * float(np.abs(w).max()), (n, d)
    assert int(got["step"]) == 1 == int(got["opt_step"])
