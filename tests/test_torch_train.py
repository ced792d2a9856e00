"""The port's training path (``repro_torch.models`` loss, ``runtime``,
``data``, ``launch.train``) on reduced configs, in float32: the
counterparts of ``tests/test_runtime.py`` (convergence, microbatching,
failure recovery, bit-exact recovered state, stragglers, the data
pipeline), and the port against the JAX package on the same inputs
made with numpy:

* ``loss_fn`` within 1e-5 relative of JAX's, and every parameter's
  gradient within 1e-4 × max|g| of ``jax.grad``'s, for the dense, SSM
  and MoE families (smollm-360m, mamba2-130m, mixtral-8x7b and
  kimi-k2 at ``reduced()``) and every ``remat``;
* three ``train_step``s from ``train_state_from_numpy`` of a JAX
  ``init_train_state``, one microbatch and two: the loss within 1e-4
  relative at every step, every parameter within 1e-3 × max|p| but for
  at most 1 element in 10^4, and those within Adam's own bound (see the
  test);
* B6's ``autograd.Function`` (its forward swapped for the plain version,
  as there is no kernel on the CPU): gradients within 1e-4 of
  ``jax.grad`` of the reference scan;
* the encoder-decoder (whisper-small) and the vlm (internvl2-1b), the
  batches carrying ``frames`` / ``patches`` made with numpy: three
  ``train_step``s against JAX's ``make_train_step`` (the loss and the
  grad norm within 1e-4 relative at every step, every parameter within
  1e-3 × max|p| but for at most 1 element in 10^4, as above, and the
  params moved, as ``tests/test_models.py`` asks of the JAX package);
  ``SyntheticLM`` gives them ``frames`` / ``patches`` and the trainer
  takes them unchanged;
* an int8 optimizer state over a model of several groups: two
  ``adamw_update``s from the same state and gradients give the JAX
  package's q and scale bit for bit, group by group (one absmax a
  stacked leaf), and ``convert.arrays_to_reference`` accepts the state
  after every update and after int8 ``train_step``s.

Multi-device training (the JAX package's
``test_elastic_reshard_preserves_values`` and its mesh steps) is held
in ``tests/test_torch_sharding.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ShardingConfig as JShardingConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.runtime import init_train_state as j_init  # noqa: E402
from repro.runtime import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.config import ShardingConfig, TrainConfig, reduced  # noqa: E402,E501
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.convert import (arrays_to_reference, lm_from_numpy,  # noqa: E402,E501
                                 train_state_from_numpy)
from repro_torch.optim import adamw_update  # noqa: E402
from repro_torch.data import SyntheticLM, batch_specs  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as SO  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime import (FailureInjector, StragglerPolicy,  # noqa: E402,E501
                                 TrainState, init_train_state,
                                 make_train_step)

ARCHS = ["smollm-360m", "mamba2-130m"]
# the MoE family, held to JAX by the loss / gradient and train-step tests
MOE_ARCHS = ["mixtral-8x7b", "kimi-k2-1t-a32b"]
TINY = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
            d_ff=128, vocab=128)


def _tiny(**over):
    return reduced(get_config("smollm-360m"), **dict(TINY, **over))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _port_batch(toks, mask=None):
    b = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    if mask is not None:
        b["mask"] = torch.from_numpy(mask)
    return b


def _jax_batch(toks, mask=None):
    b = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    if mask is not None:
        b["mask"] = jnp.asarray(mask)
    return b


# ---------------------------------------------------------------------------
# The counterparts of tests/test_runtime.py
# ---------------------------------------------------------------------------


def test_data_deterministic_and_resumable():
    cfg = reduced(get_config("smollm-360m"))
    d1 = SyntheticLM(cfg, 4, 32, seed=3, device="cpu")
    d2 = SyntheticLM(cfg, 4, 32, seed=3, device="cpu")
    b1 = d1.batch_at(17)
    b2 = d2.batch_at(17)  # fresh pipeline, same step -> same batch
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = d1.batch_at(18)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert not torch.equal(b1["tokens"], SyntheticLM(
        cfg, 4, 32, seed=4, device="cpu").batch_at(17)["tokens"])


def test_loss_decreases_tiny_model():
    cfg = _tiny(n_layers=2)
    tcfg = TrainConfig(global_batch=8, seq_len=64, lr=3e-3,
                       total_steps=40, warmup_steps=4,
                       param_dtype="float32")
    data = SyntheticLM(cfg, tcfg.global_batch, tcfg.seq_len, seed=0,
                       device="cpu")
    state = init_train_state(cfg, tcfg, device="cpu")
    step = make_train_step(cfg, tcfg, ShardingConfig())
    losses = []
    for i in range(tcfg.total_steps):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_microbatching_matches_full_batch():
    """Gradient accumulation must equal the single-batch gradient step
    (same data, same init)."""
    cfg = _tiny(vocab=64)
    batch = SyntheticLM(cfg, 8, 32, seed=1, device="cpu").batch_at(0)
    outs = {}
    for mb in (1, 4):
        tcfg = TrainConfig(global_batch=8, seq_len=32, lr=1e-3,
                           microbatches=mb, param_dtype="float32")
        state = init_train_state(cfg, tcfg, device="cpu")
        step = make_train_step(cfg, tcfg, ShardingConfig())
        s2, m = step(state, batch)
        outs[mb] = (s2.params.embed.tok.detach().clone(), float(m["loss"]))
    assert abs(outs[1][1] - outs[4][1]) < 1e-4
    assert torch.allclose(outs[1][0], outs[4][0], atol=1e-4)


def test_failure_recovery_end_to_end(tmp_path):
    """Inject failures mid-run; training must resume from the delta
    checkpoint store and reach the same final step."""
    from repro_torch.checkpoint import DeltaPolicy
    from repro_torch.launch.train import train
    cfg = _tiny()
    tcfg = TrainConfig(global_batch=4, seq_len=32, lr=1e-3,
                       total_steps=25, warmup_steps=2,
                       param_dtype="float32")
    inj = FailureInjector(fail_at=(8, 17))
    state, history, store = train(
        cfg, tcfg, ShardingConfig(), device="cpu", ckpt_dir=str(tmp_path),
        ckpt_every=5, policy=DeltaPolicy(period=2), injector=inj,
        log_every=1)
    assert state.step == tcfg.total_steps
    assert store.latest_step() == tcfg.total_steps - 1
    # recovery actually used the checkpoint: failures consumed
    assert not inj._pending
    assert [f[0] for f in inj.fired] == ["step", "step"]


def test_recovered_state_bit_exact(tmp_path):
    """The state after recovery equals the state of an uninterrupted
    run at the same step count (determinism across restarts)."""
    from repro_torch.launch.train import train
    cfg = _tiny()
    tcfg = TrainConfig(global_batch=4, seq_len=32, lr=1e-3,
                       total_steps=12, warmup_steps=2,
                       param_dtype="float32")
    s_clean, _, _ = train(cfg, tcfg, ShardingConfig(), device="cpu")
    inj = FailureInjector(fail_at=(6,))
    s_fail, _, _ = train(cfg, tcfg, ShardingConfig(), device="cpu",
                         ckpt_dir=str(tmp_path), ckpt_every=1,
                         injector=inj, log_every=100)
    for a, b in zip(s_clean.params.parameters(), s_fail.params.parameters()):
        assert torch.equal(a, b)
    for n in s_clean.opt.m:
        assert torch.equal(s_clean.opt.m[n], s_fail.opt.m[n])
        assert torch.equal(s_clean.opt.v[n], s_fail.opt.v[n])
    assert s_clean.step == s_fail.step == s_fail.opt.step == 12


def test_straggler_policy_sheds_and_restores():
    pol = StragglerPolicy(deadline_ms=100.0, restore_after=3)
    mb = 8
    # slow steps -> shed
    for _ in range(3):
        mb = pol.observe(500.0, mb)
    assert mb < 8
    shed = mb
    # healthy steps -> gradual restore (EWMA must decay below the
    # deadline first, then one doubling per `restore_after` window)
    for _ in range(40):
        mb = pol.observe(10.0, mb)
    assert mb >= 8 > shed


# ---------------------------------------------------------------------------
# The port's own pieces
# ---------------------------------------------------------------------------


def test_synthetic_lm_properties():
    """Tokens in range, Zipf-skewed (token 0 the most frequent), the
    copy splice in about half the rows, the same bits on every device
    it is asked for (drawn on the CPU), and the batch specs' shapes."""
    cfg = reduced(get_config("smollm-360m"))
    b, s = 64, 64
    toks = SyntheticLM(cfg, b, s, seed=5, device="cpu").batch_at(3)["tokens"]
    assert toks.dtype == torch.int32 and toks.shape == (b, s)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    counts = torch.bincount(toks.flatten().long(), minlength=cfg.vocab)
    assert int(counts.argmax()) == 0 and counts[0] > 4 * counts[100:].max()
    q = s // 4
    copied = (toks[:, s - q:] == toks[:, :q]).all(1).float().mean()
    assert 0.3 < float(copied) < 0.7
    specs = batch_specs(cfg, b, s)
    assert specs["tokens"].shape == (b, s) and specs["tokens"].is_meta


def test_train_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
          "--steps", "3", "--batch", "2", "--seq", "32", "--ckpt",
          str(tmp_path / "ckpt"), "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert "trained 3 steps" in out and "on cpu" in out
    assert "checkpoint storage" in out


def test_lr_is_one_indexed():
    """The first step's rate is lr / warmup (JAX's ``lr_schedule(step +
    1)``), never zero."""
    cfg = _tiny()
    tcfg = TrainConfig(global_batch=2, seq_len=16, lr=1e-3,
                       warmup_steps=4, param_dtype="float32")
    state = init_train_state(cfg, tcfg, device="cpu")
    batch = SyntheticLM(cfg, 2, 16, device="cpu").batch_at(0)
    _, m = make_train_step(cfg, tcfg, ShardingConfig())(state, batch)
    assert float(m["lr"]) == pytest.approx(1e-3 / 4)


def test_remat_rejects_an_unknown_policy():
    cfg = _tiny()
    model = api.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    batch = _port_batch(_tokens(cfg.vocab, (1, 8), 0))
    with pytest.raises(ValueError, match="remat"):
        api.loss_fn(model, batch, cfg, remat="some")


def _mm_calls_in_backward(model, batch, cfg, remat):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.n += 1
            return func(*args, **(kwargs or {}))

    loss = api.loss_fn(model, batch, cfg, remat=remat)
    with Count() as c:
        torch.autograd.grad(loss, list(model.parameters()))
    return c.n


@pytest.mark.parametrize("arch", ARCHS)
def test_block_remat_keeps_the_products(arch):
    """``remat="block"`` keeps the matmul outputs (JAX's
    ``dots_with_no_batch_dims_saveable``): its backward runs no forward
    product again, so it issues fewer ``mm``s than ``"full"``, which
    recomputes every group, and as many as ``"none"``."""
    cfg = reduced(get_config(arch))
    model = api.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    batch = _port_batch(_tokens(cfg.vocab, (2, 32), 1))
    n = {r: _mm_calls_in_backward(model, batch, cfg, r)
         for r in ("none", "block", "full")}
    assert n["block"] == n["none"] < n["full"], n


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS + MOE_ARCHS:
        jcfg = j_reduced(j_get_config(arch))
        params = japi.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        out[arch] = (jcfg, reduced(get_config(arch)), params)
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
@pytest.mark.parametrize("remat", ["none", "block", "full"])
@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_loss_and_gradients_match_jax(models, arch, remat, masked):
    jcfg, cfg, params = models[arch]
    toks = _tokens(jcfg.vocab, (2, 64), 1)
    mask = ((np.random.default_rng(2).random((2, 64)) < 0.7)
            .astype(np.int32) if masked else None)
    jl, jg = jax.value_and_grad(lambda p: japi.loss_fn(
        p, _jax_batch(toks, mask), jcfg, remat=remat))(params)
    model = lm_from_numpy(jax.tree.map(np.asarray, params), cfg,
                          device="cpu")
    want = dict(lm_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                              device="cpu").named_parameters())
    loss = api.loss_fn(model, _port_batch(toks, mask), cfg, remat=remat)
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) / float(jl) - 1) < 1e-5
    names, ps = zip(*model.named_parameters())
    for n, g in zip(names, torch.autograd.grad(loss, ps)):
        w = want[n].detach()
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), n


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_train_steps_match_jax(arch, microbatches):
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced(get_config(arch))
    kw = dict(global_batch=4, seq_len=32, lr=1e-3, warmup_steps=2,
              total_steps=10, microbatches=microbatches,
              param_dtype="float32")
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = j_init(jax.random.PRNGKey(0), jcfg, jtcfg)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu")
    jstep = jax.jit(j_make_train_step(jcfg, jtcfg, JShardingConfig()))
    step = make_train_step(cfg, tcfg, ShardingConfig())
    lr_sum = 0.0
    for i in range(3):
        toks = _tokens(jcfg.vocab, (4, 32), 10 + i)
        jstate, jm = jstep(jstate, _jax_batch(toks))
        state, m = step(state, _port_batch(toks))
        assert abs(float(m["loss"]) / float(jm["loss"]) - 1) < 1e-4, i
        lr_sum += float(m["lr"])
        want = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                      device="cpu")
        for (n, p), w in zip(state.params.named_parameters(),
                             want.params.parameters()):
            # AdamW moves an element by lr · m̂/√v̂, a ratio: where an
            # element's gradient sits at the float32 noise floor (the
            # packages' gradients agree within 1e-4 of the largest, not
            # element by element; mamba2's plain scan forms its cumsums
            # in float64, JAX's in float32), the ratio can differ by up
            # to 2 a step.  One element of mamba2's 65,536-entry
            # embedding does so at step 2 (3.1e-4 apart).
            w = w.detach()
            err = (p.detach() - w).abs()
            assert float(err.max()) <= 2 * lr_sum, (i, n)
            assert float((err > 1e-3 * float(w.abs().max())).float()
                         .mean()) <= 1e-4, (i, n)
    assert state.step == int(jstate.step) == state.opt.step == 3


@pytest.mark.parametrize("with_state0", [False, True])
def test_ssd_autograd_function_is_the_plain_backward(monkeypatch,
                                                     with_state0):
    """B6's ``torch.autograd.Function`` differentiates through the plain
    ``ssd_chunked`` (recomputed from its saved inputs) in x, dt, a, b, c
    and state0.  The launch is swapped for the plain forward, since the
    CPU has no kernel; gradients must match JAX's gradient of its
    reference scan within 1e-4 (of the largest)."""
    rng = np.random.default_rng(3)
    bsz, s, h, p, n, chunk = 2, 32, 3, 8, 4, 8
    arrs = dict(x=rng.standard_normal((bsz, s, h, p)),
                dt=np.log1p(np.exp(rng.standard_normal((bsz, s, h)))) * 0.5,
                a=-np.linspace(1.0, 4.0, h),
                b=rng.standard_normal((bsz, s, n)),
                c=rng.standard_normal((bsz, s, n)))
    if with_state0:
        arrs["state0"] = rng.standard_normal((bsz, h, p, n))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    names = list(arrs)
    w_y = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    w_h = rng.standard_normal((bsz, h, p, n)).astype(np.float32)

    def j_loss(*xs):
        kw = dict(zip(names, xs))
        y, hs = j_ssd_chunked(kw["x"], kw["dt"], kw["a"], kw["b"], kw["c"],
                              chunk, kw.get("state0"))
        return jnp.sum(y * w_y) + jnp.sum(hs * w_h)

    want = jax.grad(j_loss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(arrs[k]) for k in names))
    monkeypatch.setattr(SO, "ssd_scan_fwd", ssd_chunked)
    ts = {k: torch.from_numpy(v).requires_grad_() for k, v in arrs.items()}
    y, hs = SO._SSDScan.apply(ts["x"], ts["dt"], ts["a"], ts["b"], ts["c"],
                              chunk, ts.get("state0"))
    ((y * torch.from_numpy(w_y)).sum()
     + (hs * torch.from_numpy(w_h)).sum()).backward()
    for k, w in zip(names, want):
        w = np.asarray(w)
        got = ts[k].grad.numpy()
        assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max(), k
    # only the output that feeds the loss: the state's gradient is absent
    for t in ts.values():
        t.grad = None
    y, _ = SO._SSDScan.apply(ts["x"], ts["dt"], ts["a"], ts["b"], ts["c"],
                             chunk, ts.get("state0"))
    (y * torch.from_numpy(w_y)).sum().backward()
    assert all(t.grad is not None for t in ts.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_state_shares_one_scale_per_stacked_leaf(arch):
    """The JAX package quantizes a leaf that stacks every group against
    one absmax; the port, which keeps a tensor a group, quantizes the
    groups of that leaf together.  Two updates from the JAX package's
    initial int8 state with the same numpy gradients: every group's q
    and scale equal the stacked leaf's bit for bit (as
    ``test_torch_optim`` holds int8 on ungrouped tensors), and the
    state's npz entries convert to the JAX package's names."""
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced(get_config(arch))
    # no clipping: an active clip factor carries the global norm's
    # summation order, which differs between the packages in the last
    # bit (``test_torch_optim.test_adamw_update_matches_jax``)
    kw = dict(lr=1e-2, weight_decay=0.1, opt_state_dtype="int8",
              param_dtype="float32", grad_clip=1e9)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = j_init(jax.random.PRNGKey(4), jcfg, jtcfg)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu")
    groups = {n.split(".")[1] for n in state.opt.m if n.startswith("groups.")}
    assert len(groups) > 1
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
        port = TrainState(params=params, opt=opt, step=step + 1)
        arrays_to_reference(io.raw_arrays(port))

    # and through the train step, several steps
    tcfg = TrainConfig(global_batch=2, seq_len=16, total_steps=4,
                       **kw)
    state = init_train_state(cfg, tcfg, device="cpu")
    step_fn = make_train_step(cfg, tcfg, ShardingConfig())
    for i in range(3):
        state, _ = step_fn(state, _port_batch(_tokens(cfg.vocab, (2, 16),
                                                      20 + i)))
        arrays_to_reference(io.raw_arrays(state))
    assert state.step == 3


# ---------------------------------------------------------------------------
# The encoder-decoder and vlm families
# ---------------------------------------------------------------------------

FAMILIES = ["whisper-small", "internvl2-1b"]


def _family_batch(cfg, toks, seed):
    """tokens / labels and the family's stub input (``frames`` or
    ``patches``, standard normal float32, as ``tests/test_models.py``
    makes them), as numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": toks, "labels": toks}
    name, rows = (("frames", cfg.enc_seq) if cfg.family == "encdec"
                  else ("patches", cfg.n_patches))
    b[name] = rng.standard_normal((toks.shape[0], rows, cfg.d_model)) \
        .astype(np.float32)
    return b


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_steps_match_jax(arch):
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced(get_config(arch))
    kw = dict(global_batch=2, seq_len=32, lr=1e-3, warmup_steps=2,
              total_steps=10, param_dtype="float32")
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = j_init(jax.random.PRNGKey(0), jcfg, jtcfg)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu")
    start = [p.detach().clone() for p in state.params.parameters()]
    jstep = jax.jit(j_make_train_step(jcfg, jtcfg, JShardingConfig()))
    step = make_train_step(cfg, tcfg, ShardingConfig())
    lr_sum = 0.0
    for i in range(3):
        nb = _family_batch(jcfg, _tokens(jcfg.vocab, (2, 32), 10 + i), i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in nb.items()})
        assert np.isfinite(float(m["loss"]))
        assert abs(float(m["loss"]) / float(jm["loss"]) - 1) < 1e-4, i
        assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) \
            < 1e-4, i
        lr_sum += float(m["lr"])
        want = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                      device="cpu")
        for (n, p), w in zip(state.params.named_parameters(),
                             want.params.parameters()):
            w = w.detach()
            err = (p.detach() - w).abs()
            assert float(err.max()) <= 2 * lr_sum, (i, n)
            assert float((err > 1e-3 * float(w.abs().max())).float()
                         .mean()) <= 1e-4, (i, n)
    assert state.step == int(jstate.step) == 3
    moved = sum(float((p.detach() - q).abs().sum())
                for p, q in zip(state.params.parameters(), start))
    assert moved > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_synthetic_batches_carry_frames_and_patches(arch):
    """``batch_at`` adds the family's float32 stub input, 0.02 · N(0, 1)
    from the step's generator: a pure function of (seed, step), and its
    batch specs say the same shapes; the trainer takes the batches as
    they come."""
    cfg = reduced(get_config(arch))
    name, rows = (("frames", cfg.enc_seq) if cfg.family == "encdec"
                  else ("patches", cfg.n_patches))
    data = SyntheticLM(cfg, 4, 32, seed=3, device="cpu")
    b = data.batch_at(17)
    assert set(b) == {"tokens", "labels", name}
    x = b[name]
    assert x.dtype == torch.float32 and x.shape == (4, rows, cfg.d_model)
    assert 0.015 < float(x.std()) < 0.025
    assert torch.equal(x, SyntheticLM(cfg, 4, 32, seed=3,
                                      device="cpu").batch_at(17)[name])
    assert torch.equal(b["tokens"], SyntheticLM(
        cfg, 4, 32, seed=3, device="cpu").batch_at(17)["tokens"])
    assert not torch.equal(x, data.batch_at(18)[name])
    assert not torch.equal(x, SyntheticLM(cfg, 4, 32, seed=4,
                                          device="cpu").batch_at(17)[name])
    spec = batch_specs(cfg, 4, 32)[name]
    assert spec.is_meta and spec.shape == x.shape and spec.dtype == x.dtype
    # the tokens are those of a family without stub inputs
    plain = reduced(get_config("smollm-360m"), vocab=cfg.vocab)
    assert torch.equal(b["tokens"], SyntheticLM(
        plain, 4, 32, seed=3, device="cpu").batch_at(17)["tokens"])
    tcfg = TrainConfig(global_batch=4, seq_len=32, total_steps=2,
                       param_dtype="float32", microbatches=2)
    state = init_train_state(cfg, tcfg, device="cpu")
    state, m = make_train_step(cfg, tcfg, ShardingConfig())(state, b)
    assert np.isfinite(float(m["loss"])) and state.step == 1
