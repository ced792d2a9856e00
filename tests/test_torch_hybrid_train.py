"""The hybrid family's training path against the JAX package on the
CPU (jamba-1.5-large at ``reduced()``, one period of 8 layers and two,
``n_layers=16``; float32), and its optimizer state and checkpoints at
two periods:

* three ``train_step``s at 1 and 2 microbatches, each from the JAX
  package's state before it (params, AdamW moments and counters carried
  across by ``convert``) and held to the JAX package's state after it:
  the loss within 1e-4 relative, every parameter and moment element
  within ``tests/test_torch_train.py``'s rule (at most 1 element in 10^4
  beyond 1e-3 × the leaf's max|·|) and every parameter element within
  2 · lr of the step;
* at one period, the same three steps run on from the port's own state,
  held to JAX's run with a per-leaf rule taken from the JAX package's
  own spread (``SPREAD_FACTOR``);
* the checkpoint name map both ways, the int8 optimizer state's one
  absmax per stacked leaf across both groups (C5), and a delta store
  whose root equals the JAX package's and restores bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.checkpoint.io import _paths_and_leaves  # noqa: E402
from repro.config import ShardingConfig as JShardingConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.runtime import init_train_state as j_init  # noqa: E402
from repro.runtime import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.checkpoint import (DeltaCheckpointStore,  # noqa: E402
                                    DeltaPolicy, io)
from repro_torch.config import ShardingConfig, TrainConfig, reduced  # noqa: E402,E501
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (arrays_from_reference,  # noqa: E402
                                 arrays_to_reference, lm_from_numpy,
                                 train_state_from_numpy)
from repro_torch.optim import adamw_update  # noqa: E402
from repro_torch.runtime import (TrainState, init_train_state,  # noqa: E402
                                 make_train_step)

ARCH = "jamba-1.5-large-398b"
# one period (8 layers) and two (16: the JAX package stacks two groups)
PERIODS = {"1period": 8, "2periods": 16}
TRAIN_STEPS = 3
TRAIN_KW = dict(global_batch=4, seq_len=32, lr=1e-3, warmup_steps=2,
                total_steps=10, param_dtype="float32")
# The run-on steps' per-leaf rule.  AdamW moves an element by
# lr · m̂/√v̂, a ratio of float32 sums, so where a gradient sits near the
# float32 noise floor two correct runs part by up to lr a step, and the
# parts feed the later steps: the JAX package against itself, at 1
# microbatch and at 2 (the same gradient summed in another order), parts
# by 2.4e-5 in the 8-element ``ssm.dt_bias`` leaves and by 3.1e-4 in
# ``l3.moe.w_gate`` at step 2.  The share rule of
# ``tests/test_torch_train.py`` cannot pass an 8-element leaf that sits
# at that noise.  So an element of a run-on step may also sit up to
# SPREAD_FACTOR times the JAX package's own 1-vs-2-microbatch spread on
# its leaf at that step from JAX's (the port read 1.7× and 2.1× of it on
# those two leaves, with this factor fixed knowing that); the loss and
# Σ lr rules stay.  At two periods the run-on steps part further, through
# the routers: from the parameters each run reaches after two steps, 6 of
# 128 tokens take other experts in some MoE layer (float32 near-ties of
# reduced()'s small random routers) and the third step's losses part by
# 7.1e-4, which no rule of float32 rounding takes; each step from the JAX
# package's own state (above) holds there as at one period.
SPREAD_FACTOR = 4.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced model's ops are too small to gain from intra-op
    threads, and under ``pytest -n`` a worker's threads spin against the
    other workers': the port runs this file on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(n_layers):
    return (j_reduced(j_get_config(ARCH), n_layers=n_layers),
            reduced(get_config(ARCH), n_layers=n_layers))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _batch(toks, lib=torch.from_numpy):
    return {"tokens": lib(toks), "labels": lib(toks)}


def _step_tokens(vocab, i):
    return _tokens(vocab, (4, 32), 10 + i)


@pytest.fixture(scope="module")
def jax_runs():
    """Per (depth, microbatches): the JAX package's TrainState before the
    first step and after each of TRAIN_STEPS (numpy), and each step's
    loss."""
    out = {}
    for depth, n in PERIODS.items():
        jcfg, _ = _configs(n)
        for mb in (1, 2):
            jtcfg = JTrainConfig(microbatches=mb, **TRAIN_KW)
            jstate = j_init(jax.random.PRNGKey(0), jcfg, jtcfg)
            jstep = jax.jit(j_make_train_step(jcfg, jtcfg, JShardingConfig()))
            states, losses = [jax.tree.map(np.asarray, jstate)], []
            for i in range(TRAIN_STEPS):
                jstate, jm = jstep(jstate, _batch(_step_tokens(jcfg.vocab, i),
                                                  jnp.asarray))
                states.append(jax.tree.map(np.asarray, jstate))
                losses.append(float(jm["loss"]))
            out[depth, mb] = (states, losses)
    return out


def _few_beyond(got, want, name):
    """``tests/test_torch_train.py``'s share rule on one leaf."""
    err = (got - want).abs()
    assert float((err > 1e-3 * float(want.abs().max())).float().mean()) \
        <= 1e-4, name
    return err


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("depth", sorted(PERIODS))
def test_train_steps_match_jax(jax_runs, depth, microbatches):
    jcfg, cfg = _configs(PERIODS[depth])
    states, losses = jax_runs[depth, microbatches]
    step = make_train_step(cfg, TrainConfig(microbatches=microbatches,
                                            **TRAIN_KW), ShardingConfig())
    for i in range(TRAIN_STEPS):
        state, m = step(train_state_from_numpy(states[i], cfg, device="cpu"),
                        _batch(_step_tokens(jcfg.vocab, i)))
        assert abs(float(m["loss"]) / losses[i] - 1) < 1e-4, i
        want = train_state_from_numpy(states[i + 1], cfg, device="cpu")
        assert state.step == state.opt.step == want.step == i + 1
        for (n, p), w in zip(state.params.named_parameters(),
                             want.params.parameters()):
            err = _few_beyond(p.detach(), w.detach(), (i, n))
            assert float(err.max()) <= 2 * float(m["lr"]), (i, n)
        for moment in ("m", "v"):
            ours, theirs = getattr(state.opt, moment), getattr(want.opt,
                                                               moment)
            for n in ours:
                _few_beyond(ours[n], theirs[n], (i, moment, n))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_steps_run_on_from_the_ports_state(jax_runs, microbatches):
    jcfg, cfg = _configs(PERIODS["1period"])
    states, losses = jax_runs["1period", microbatches]
    other, _ = jax_runs["1period", 3 - microbatches]
    state = train_state_from_numpy(states[0], cfg, device="cpu")
    step = make_train_step(cfg, TrainConfig(microbatches=microbatches,
                                            **TRAIN_KW), ShardingConfig())
    lr_sum = 0.0
    for i in range(TRAIN_STEPS):
        state, m = step(state, _batch(_step_tokens(jcfg.vocab, i)))
        assert abs(float(m["loss"]) / losses[i] - 1) < 1e-4, i
        lr_sum += float(m["lr"])
        want = dict(lm_from_numpy(states[i + 1].params, cfg,
                                  device="cpu").named_parameters())
        spread = dict(lm_from_numpy(other[i + 1].params, cfg,
                                    device="cpu").named_parameters())
        for n, p in state.params.named_parameters():
            w = want[n].detach()
            err = (p.detach() - w).abs()
            assert float(err.max()) <= 2 * lr_sum, (i, n)
            allowed = max(1e-3 * float(w.abs().max()), SPREAD_FACTOR * float(
                (spread[n].detach() - w).abs().max()))
            assert float((err > allowed).float().mean()) <= 1e-4, (i, n)
    assert state.step == state.opt.step == TRAIN_STEPS


# ---------------------------------------------------------------------------
# Checkpoints and the optimizer state at two periods
# ---------------------------------------------------------------------------


def _ref_arrays(tree, prefix=""):
    """A JAX tree's leaves as the JAX package's npz names them."""
    ref = {}
    for k, leaf in _paths_and_leaves(tree):
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            ref[prefix + k + "::bf16"] = a.view(np.uint16)
        else:
            ref[prefix + k] = a
    return ref


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16", "int8"])
def test_name_map_both_ways(opt_dtype):
    """A JAX TrainState of two periods carried into the port and back:
    ``arrays_from_reference`` / ``arrays_to_reference`` bit for bit, the
    params through ``lm_from_numpy`` too, and a stacked int8 leaf's one
    scale given to both groups."""
    jcfg, cfg = _configs(16)
    js = j_init(jax.random.PRNGKey(1), jcfg, JTrainConfig(
        param_dtype="bfloat16", opt_state_dtype=opt_dtype))
    ref = _ref_arrays(js)
    port = io.raw_arrays(train_state_from_numpy(
        jax.tree.map(np.asarray, js), cfg, device="cpu"))
    mapped = arrays_from_reference(ref)
    assert set(mapped) == set(port)
    for k in port:
        assert mapped[k].shape == port[k].shape and \
            mapped[k].tobytes() == port[k].tobytes(), k
    back = arrays_to_reference(port)
    assert set(back) == set(ref)
    for k in ref:
        assert back[k].dtype == ref[k].dtype and \
            back[k].tobytes() == ref[k].tobytes(), k
    model = lm_from_numpy(jax.tree.map(np.asarray, js.params), cfg,
                          device="cpu")
    params_back = arrays_to_reference(io.raw_arrays({"params": model}))
    want = _ref_arrays(js.params, ".params/")
    assert set(params_back) == set(want)
    for k in want:
        assert params_back[k].tobytes() == want[k].tobytes(), k
    if opt_dtype == "int8":
        for leaf in ("l0.ssm.in_proj", "l4.attn.wq", "l1.moe.w_up"):
            scales = [port[f"opt/m/groups.{g}.{leaf}/scale"]
                      for g in range(2)]
            assert scales[0].tobytes() == scales[1].tobytes(), leaf


def test_int8_state_shares_one_scale_per_stacked_leaf():
    """Two ``adamw_update``s of an int8 state from the JAX package's
    initial state with the same numpy gradients: every group's q and
    scale equal the stacked leaf's bit for bit (one absmax across both
    periods, C5), and the state converts to the JAX names after each
    update and after int8 ``train_step``s."""
    jcfg, cfg = _configs(16)
    # no clipping: an active clip factor carries the global norm's
    # summation order, which differs between the packages in the last bit
    kw = dict(lr=1e-2, weight_decay=0.1, opt_state_dtype="int8",
              param_dtype="float32", grad_clip=1e9)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = j_init(jax.random.PRNGKey(4), jcfg, jtcfg)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu")
    jparams, jopt = jstate.params, jstate.opt
    params, opt = state.params, state.opt
    rng = np.random.default_rng(5)
    for step in range(2):
        g_np = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3)
                            .astype(np.float32), jax.tree.map(
                                np.asarray, jparams))
        grads = dict(lm_from_numpy(g_np, cfg, device="cpu")
                     .named_parameters())
        params, opt, _ = adamw_update({n: g.detach()
                                       for n, g in grads.items()},
                                      opt, params, tcfg, 1e-2)
        jparams, jopt, _ = j_adamw_update(
            jax.tree.map(jnp.asarray, g_np), jopt, jparams, jtcfg,
            jnp.float32(1e-2))
        want = train_state_from_numpy(jax.tree.map(np.asarray, dict(
            params=jparams, opt=jopt, step=step + 1)), cfg, device="cpu")
        for moment in ("m", "v"):
            ours, theirs = getattr(opt, moment), getattr(want.opt, moment)
            for n in ours:
                assert torch.equal(ours[n].q, theirs[n].q), (step, n)
                assert ours[n].scale.numpy().tobytes() == \
                    theirs[n].scale.numpy().tobytes(), (step, n)
        arrays_to_reference(io.raw_arrays(TrainState(params=params, opt=opt,
                                                     step=step + 1)))
    tcfg = TrainConfig(global_batch=2, seq_len=16, total_steps=4, **kw)
    state = init_train_state(cfg, tcfg, device="cpu")
    step_fn = make_train_step(cfg, tcfg, ShardingConfig())
    for i in range(2):
        state, _ = step_fn(state, _batch(_tokens(cfg.vocab, (2, 16), 20 + i)))
        arrays_to_reference(io.raw_arrays(state))


DELTA_STEPS = [0, 1, 2, 4, 5]


@pytest.mark.parametrize("opt_dtype", ["float32", "int8"])
def test_delta_store_matches_jax_and_restores(tmp_path, opt_dtype):
    """Two stores, one per package, fed the same TrainStates of two
    periods (bf16 params; each state a perturbation of the last) write
    the same manifest and byte-equal arrays under the name map, and the
    port restores every step bit-equal to what it saved."""
    jcfg, cfg = _configs(16)
    st = jax.tree.map(np.asarray, j_init(
        jax.random.PRNGKey(3), jcfg, JTrainConfig(
            param_dtype="bfloat16", opt_state_dtype=opt_dtype)))
    rng = np.random.default_rng(3)
    states = [st]
    for _ in DELTA_STEPS[1:]:
        def move(a):
            a = np.array(a)
            hit = rng.random(a.shape) < 0.1
            if a.dtype == np.int8:
                return np.where(hit, np.clip(a + 1, -127, 127),
                                a).astype(np.int8)
            if a.dtype == np.int32:
                return a + 1
            noise = rng.standard_normal(a.shape).astype(np.float32)
            return np.where(hit, a.astype(np.float32) + 0.05 * noise,
                            a.astype(np.float32)).astype(a.dtype)
        states.append(jax.tree.map(move, states[-1]))
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore = jckpt.DeltaCheckpointStore(jroot, jckpt.DeltaPolicy(period=2))
    store = DeltaCheckpointStore(root, DeltaPolicy(period=2))
    saved = {}
    for step, s in zip(DELTA_STEPS, states):
        jstore.save(step, jax.tree.map(jnp.asarray, s))
        port = train_state_from_numpy(s, cfg, device="cpu")
        saved[step] = io.raw_arrays(port)
        store.save(step, port)
    with open(os.path.join(jroot, "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(root, "manifest.json")) as f:
        assert json.load(f) == jman
    assert len(jman["snapshots"]) > 1
    for d in ("snapshots", "deltas"):
        for name in os.listdir(os.path.join(jroot, d)):
            with np.load(os.path.join(jroot, d, name)) as z:
                want = {k: z[k] for k in z.files}
            with np.load(os.path.join(root, d, name)) as z:
                got = arrays_to_reference({k: z[k] for k in z.files})
            assert set(got) == set(want), name
            for k in want:
                assert got[k].tobytes() == want[k].tobytes(), (name, k)
    template = init_train_state(cfg, TrainConfig(
        param_dtype="bfloat16", opt_state_dtype=opt_dtype), device="cpu")
    for step in DELTA_STEPS:
        got = io.raw_arrays(store.restore(step, template))
        assert set(got) == set(saved[step])
        for k, a in saved[step].items():
            assert got[k].dtype == a.dtype and \
                got[k].tobytes() == a.tobytes(), (step, k)


