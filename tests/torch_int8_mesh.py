"""The int8 optimizer state on a mesh against the single-device JAX step,
shared by the ``gloo`` groups of ``tests/test_torch_sharding.py`` and
``tests/test_torch_expert_parallel.py``.

A process of the group runs ``int8_steps``: train steps with
``opt_state_dtype="int8"`` on a mesh from the JAX package's initial
state, rank 0 writing each step's gradients (the step's own, as
``make_train_step`` takes them from ``make_grad_fn``), loss, learning
rate and state after it.  The parent holds each step with
``check_int8_steps`` to the single-device JAX step taken from the same
state — the mesh's own state before it, so that no step inherits
another's noise:

* the loss within ``LOSS_BOUND`` of the reference's ``loss_fn`` there,
  and every gradient within ``GRAD_BOUND`` of its largest entry of
  ``jax.grad``'s (the bounds the groups hold their float32 steps to);
* the update, under ``tests/test_torch_optim.py``'s int8 rule: the
  reference's ``adamw_update`` on the step's own gradients gives every
  ``q`` and every ``scale`` bit for bit, and every parameter within
  1e-6 of its largest entry.  ``grad_clip`` is set out of reach, so
  the clip factor is exactly 1 (an active clip carries the global
  norm's summation order, which differs between the packages in the
  last bit: that rule holds only float32 state there).
"""
import os

import numpy as np

LOSS_BOUND = 1e-4
GRAD_BOUND = 1e-4
PARAM_REL = 1e-6
INT8_STEPS = 2
INT8_KW = dict(lr=1e-3, param_dtype="float32", opt_state_dtype="int8",
               grad_clip=1e9, warmup_steps=1)


def int8_steps(cfg, tcfg, init_npz: str, batch: dict, mesh, out: str,
               tag: str, rank: int, n_steps: int = INT8_STEPS) -> dict:
    """``n_steps`` int8 train steps of ``cfg`` on ``mesh`` from the state
    at ``init_npz``; rank 0 writes ``<out>/int8_<tag>_<k>.npz`` (grad/,
    state/, loss, lr) for step k.  Returns the placements' facts: each
    ``q`` placed as its parameter, each ``scale`` replicated."""
    from unittest import mock

    import torch
    from torch.distributed.tensor import Replicate

    from repro_torch.checkpoint import io
    from repro_torch.config import ShardingConfig
    from repro_torch.launch.dryrun import batch_sharding
    from repro_torch.runtime import (init_train_state, make_train_step,
                                     reshard_state, steps)
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import mesh_context

    grads: dict = {}
    make_grad_fn = steps.make_grad_fn

    def recording(*args):
        grad_fn = make_grad_fn(*args)

        def recorded(params, b):
            loss, g = grad_fn(params, b)
            grads.clear()
            grads.update(io.raw_arrays(g))
            return loss, g
        return recorded

    state = reshard_state(io.load_into(init_train_state(cfg, tcfg,
                                                        device="cpu"),
                                       init_npz), mesh)
    placed = place_tree(batch, batch_sharding(batch, mesh))
    for k in range(1, n_steps + 1):
        with mesh_context(mesh), mock.patch.object(steps, "make_grad_fn",
                                                   recording):
            state, m = make_train_step(cfg, tcfg, ShardingConfig())(state,
                                                                    placed)
        raw = io.raw_arrays(state)
        if rank == 0:
            np.savez(os.path.join(out, f"int8_{tag}_{k}.npz"),
                     **{f"grad/{n}": g for n, g in grads.items()},
                     **{f"state/{n}": a for n, a in raw.items()},
                     loss=float(m["loss"]), lr=float(m["lr"]))
    params = dict(state.params.named_parameters())
    return {"q_as_param": all(
                state.opt.m[n].q.placements == p.placements
                and state.opt.v[n].q.placements == p.placements
                for n, p in params.items()),
            "scale_replicated": all(
                all(isinstance(pl, Replicate) for pl in x.scale.placements)
                for mv in (state.opt.m, state.opt.v) for x in mv.values()),
            "q_int8": all(x.q.dtype == torch.int8
                          for x in state.opt.m.values())}


def _to_jax(raw: dict, template, path: str):
    """The port's raw arrays of a ``TrainState`` as the JAX package's
    ``TrainState`` (``template``'s structure)."""
    from repro.checkpoint import io as jio
    from repro_torch.convert import arrays_to_reference
    np.savez(path, **arrays_to_reference(raw))
    return jio.load_into(template, path)


def check_int8_steps(out: str, tag: str, jcfg, jtcfg, jstate, jbatch, cfg,
                     n_steps: int = INT8_STEPS,
                     loss_bound: float = LOSS_BOUND) -> None:
    """Hold each of ``int8_steps``' steps to the JAX step from the same
    state (see the module's docstring; ``loss_bound`` the group's own for
    the family); raises AssertionError."""
    import jax
    import jax.numpy as jnp

    from repro.models import api as japi
    from repro.optim import adamw as jadamw
    from repro_torch.checkpoint import io
    from repro_torch.convert import train_state_from_numpy

    loss_fn = jax.jit(lambda p: japi.loss_fn(p, jbatch, jcfg))
    grad_fn = jax.jit(jax.grad(lambda p: japi.loss_fn(p, jbatch, jcfg)))
    before_raw = io.raw_arrays(train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), cfg, device="cpu"))
    before = jstate
    for k in range(1, n_steps + 1):
        got = np.load(os.path.join(out, f"int8_{tag}_{k}.npz"))
        where = f"{tag} step {k}"
        loss = float(loss_fn(before.params))
        assert abs(float(got["loss"]) - loss) < loss_bound, (where, loss)
        grads_raw = {key: got[f"grad/{key[len('params/'):]}"]
                     if key.startswith("params/") else a
                     for key, a in before_raw.items()}
        jgrads = _to_jax(grads_raw, jstate,
                         os.path.join(out, f"jax_{tag}_{k}_grads.npz")).params
        want_g = _port_params(grad_fn(before.params), jstate, cfg)
        for n, w in want_g.items():
            d = float(np.abs(got[f"grad/{n}"] - w).max())
            assert d <= GRAD_BOUND * float(np.abs(w).max()), (where, n, d)
        params, opt, _ = jadamw.adamw_update(
            jgrads, before.opt, before.params, jtcfg,
            jnp.float32(float(got["lr"])))
        want = io.raw_arrays(train_state_from_numpy(jax.tree.map(
            np.asarray, {"params": params, "opt": opt, "step": k}), cfg,
            device="cpu"))
        for key, w in want.items():
            g = got[f"state/{key}"]
            if key.endswith(("/q", "/scale")) or key in ("step", "opt/step"):
                assert g.tobytes() == w.tobytes(), (where, key)
            else:
                d = float(np.abs(g - w).max())
                assert d <= PARAM_REL * float(np.abs(w).max()), (
                    where, key, d)
        before_raw = {key: got[f"state/{key}"] for key in want}
        before = _to_jax(before_raw, jstate,
                         os.path.join(out, f"jax_{tag}_{k}.npz"))


def _port_params(tree, jstate, cfg) -> dict:
    """A JAX params-shaped tree (gradients) under the port's names."""
    import jax

    from repro_torch.convert import lm_from_numpy
    return {n: p.detach().numpy() for n, p in lm_from_numpy(
        jax.tree.map(np.asarray, tree), cfg,
        device="cpu").named_parameters()}
