"""The port's optimizer (``repro_torch.optim``): the counterparts of
``tests/test_optim.py`` (AdamW against a numpy reference, every state
dtype on a toy regression, the int8 round trip, the schedule), and the
port against ``repro.optim`` on the same inputs made with numpy.

Tolerances: one ``adamw_update`` of params, m and v within 1e-6
relative (both packages compute it in float32, op for op; the global
norm sums its leaves in orders of their own), the int8 ``QTensor``'s q
and scale bit-equal, and ``lr_schedule`` within 1e-7 of lr (float32,
one ``cos``).  An int8 state over an encoder-decoder's layers, which
the JAX package stacks under ``enc`` and ``dec``, gives its q and scale
layer by layer (one absmax a stacked leaf, ``adamw.STACKED``).
``compress.py`` (the int8 cross-device reduce) is not ported yet, so
``test_error_feedback_unbiased`` has no counterpart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import lr_schedule as j_lr_schedule  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.optim import (QTensor, adamw_init, adamw_update,  # noqa: E402
                               global_norm, lr_schedule)

DTYPES = ["float32", "bfloat16", "int8"]


def _np_adamw(params, grads, m, v, step, cfg, lr):
    gnorm = np.sqrt(sum((g ** 2).sum() for g in grads))
    clip = min(1.0, cfg.grad_clip / (gnorm + 1e-9))
    out_p, out_m, out_v = [], [], []
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    for p, g, mm, vv in zip(params, grads, m, v):
        g = g * clip
        mm = cfg.b1 * mm + (1 - cfg.b1) * g
        vv = cfg.b2 * vv + (1 - cfg.b2) * g * g
        upd = (mm / bc1) / (np.sqrt(vv / bc2) + cfg.eps)
        p = p - lr * (upd + cfg.weight_decay * p)
        out_p.append(p)
        out_m.append(mm)
        out_v.append(vv)
    return out_p, out_m, out_v


def test_adamw_matches_numpy():
    rng = np.random.default_rng(0)
    cfg = TrainConfig(lr=1e-2, weight_decay=0.01)
    params = {"a": torch.tensor(rng.standard_normal((4, 5)),
                                dtype=torch.float32),
              "b": torch.tensor(rng.standard_normal((3,)),
                                dtype=torch.float32)}
    state = adamw_init(params, cfg)
    np_p = [params["a"].numpy().copy(), params["b"].numpy().copy()]
    np_m = [np.zeros_like(x) for x in np_p]
    np_v = [np.zeros_like(x) for x in np_p]
    for step in range(1, 5):
        grads = {"a": torch.tensor(rng.standard_normal((4, 5)),
                                   dtype=torch.float32),
                 "b": torch.tensor(rng.standard_normal((3,)),
                                   dtype=torch.float32)}
        params, state, _ = adamw_update(grads, state, params, cfg, 1e-2)
        np_p, np_m, np_v = _np_adamw(
            np_p, [grads["a"].numpy(), grads["b"].numpy()],
            np_m, np_v, step, cfg, 1e-2)
        assert np.allclose(params["a"].numpy(), np_p[0], atol=1e-5)
        assert np.allclose(params["b"].numpy(), np_p[1], atol=1e-5)
        assert state.step == step


@pytest.mark.parametrize("dtype", DTYPES)
def test_state_dtypes_reduce_loss(dtype):
    """A toy regression must converge under every opt-state dtype."""
    rng = np.random.default_rng(1)
    w_true = rng.standard_normal((8, 1)).astype(np.float32)
    X = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    y = X @ torch.from_numpy(w_true)
    cfg = TrainConfig(lr=5e-2, weight_decay=0.0, opt_state_dtype=dtype,
                      grad_clip=10.0)
    params = {"w": torch.zeros((8, 1), requires_grad=True)}
    state = adamw_init(params, cfg)

    def loss(p):
        return ((X @ p["w"] - y) ** 2).mean()

    l0 = float(loss(params).detach())
    for _ in range(60):
        (g,) = torch.autograd.grad(loss(params), [params["w"]])
        params, state, _ = adamw_update({"w": g}, state, params, cfg, 5e-2)
    l1 = float(loss(params).detach())
    assert l1 < 0.2 * l0, (dtype, l0, l1)
    m = state.m["w"]
    if dtype == "int8":
        assert m.q.dtype == torch.int8 and m.scale.dtype == torch.float32
    else:
        assert m.dtype == getattr(torch, dtype)


def test_qtensor_roundtrip_bounded():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((32, 16)), dtype=torch.float32)
    q = QTensor.quantize(x)
    err = float((q.dequantize() - x).abs().max())
    assert err <= float(q.scale) * 0.5 + 1e-7
    zero = QTensor.quantize(torch.zeros(3))
    assert float(zero.scale) == 1.0 and not zero.q.any()


def test_schedule_warmup_and_decay():
    cfg = TrainConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(lr_schedule(0, cfg)) == 0.0
    assert abs(float(lr_schedule(10, cfg)) - 1e-3) < 1e-9
    assert float(lr_schedule(100, cfg)) < 1e-6
    assert lr_schedule(torch.tensor(5), cfg).dtype == torch.float32


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _same_cfg(**kw):
    return TrainConfig(**kw), JTrainConfig(**kw)


def _load(x):
    return x.dequantize() if isinstance(x, QTensor) else x.float()


@pytest.mark.parametrize("dtype,grad_clip", [
    ("float32", 1e9), ("bfloat16", 1e9), ("int8", 1e9), ("float32", 1.0)],
    ids=["float32", "bfloat16", "int8", "float32-clipped"])
def test_adamw_update_matches_jax(dtype, grad_clip):
    """Two ``adamw_update``s from the same params, gradients and state:
    params, m and v within 1e-6 relative; an int8 state's q and scale
    bit-equal.  The clip factor is exactly 1 where ``grad_clip`` is
    large; where it is active (grad norm above 1) it carries the global
    norm's summation order, which differs between the packages in the
    last bit, so only the float32 state is held there (one ulp of m
    moves a bf16 rounding or an int8 step)."""
    rng = np.random.default_rng(3)
    cfg, jcfg = _same_cfg(lr=1e-2, weight_decay=0.1,
                          opt_state_dtype=dtype, grad_clip=grad_clip)
    shapes = {"a": (16, 9), "b": (7,), "c": (3, 4, 5)}
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    params = {k: torch.from_numpy(a.copy()) for k, a in p_np.items()}
    jparams = {k: jnp.asarray(a) for k, a in p_np.items()}
    state, jstate = adamw_init(params, cfg), jadamw.adamw_init(jparams, jcfg)
    for step in range(2):
        g_np = {k: (rng.standard_normal(s) * 3).astype(np.float32)
                for k, s in shapes.items()}
        lr = float(j_lr_schedule(jnp.int32(step + 1), jcfg))
        params, state, stats = adamw_update(
            {k: torch.from_numpy(a) for k, a in g_np.items()}, state,
            params, cfg, lr)
        jparams, jstate, jstats = jadamw.adamw_update(
            {k: jnp.asarray(a) for k, a in g_np.items()}, jstate, jparams,
            jcfg, jnp.float32(lr))
        assert float(stats["grad_norm"]) == pytest.approx(
            float(jstats["grad_norm"]), rel=1e-6)
        for k in shapes:
            want = np.asarray(jparams[k])
            got = params[k].numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
            for ours, theirs in ((state.m[k], jstate.m[k]),
                                 (state.v[k], jstate.v[k])):
                if dtype == "int8":
                    assert np.array_equal(ours.q.numpy(),
                                          np.asarray(theirs.q))
                    assert ours.scale.numpy().tobytes() == \
                        np.asarray(theirs.scale).tobytes()
                w = np.asarray(jadamw._load(theirs))
                got = _load(ours).numpy()
                assert np.abs(got - w).max() <= 1e-6 * np.abs(w).max()
    assert state.step == int(jstate.step) == 2


def test_global_norm_matches_jax():
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((33, 7), (5,), (2, 3, 4))]
    want = float(jadamw.global_norm([jnp.asarray(a) for a in arrs]))
    got = float(global_norm(torch.from_numpy(a) for a in arrs))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("warmup,total", [(1, 6), (10, 100), (100, 1000)])
def test_lr_schedule_matches_jax(warmup, total):
    cfg, jcfg = _same_cfg(lr=3e-4, warmup_steps=warmup, total_steps=total)
    steps = np.arange(0, total + 5, max(1, total // 50))
    got = np.array([float(lr_schedule(int(s), cfg)) for s in steps])
    want = np.array([float(j_lr_schedule(jnp.int32(s), jcfg))
                     for s in steps])
    assert np.abs(got - want).max() <= 1e-7 * cfg.lr
    assert got.dtype == np.float64 and want[0] == got[0] == 0.0


def test_adamw_init_matches_jax_shapes_and_dtypes():
    """Zero m / v in the state dtype, one per parameter, on its device."""
    for dtype in DTYPES:
        cfg = TrainConfig(opt_state_dtype=dtype)
        params = {"w": torch.ones((4, 3)), "b": torch.ones((3,))}
        st = adamw_init(params, cfg)
        jst = jadamw.adamw_init(jax.tree.map(
            lambda t: jnp.asarray(t.numpy()), params), JTrainConfig(
                opt_state_dtype=dtype))
        assert st.step == int(jst.step) == 0
        for k in params:
            ours, theirs = st.m[k], jst.m[k]
            if dtype == "int8":
                assert np.array_equal(ours.q.numpy(), np.asarray(theirs.q))
                assert float(ours.scale) == float(theirs.scale)
            else:
                assert str(ours.dtype).endswith(np.asarray(theirs).dtype.name)
                assert not ours.any()


def test_stack_key_names_every_stacked_prefix():
    from repro_torch.optim.adamw import STACKED, stack_key
    assert STACKED == ("groups", "enc", "dec")
    assert stack_key("groups.3.l0.attn.wq") == "groups.l0.attn.wq"
    assert stack_key("enc.11.mlp.w_up") == "enc.mlp.w_up"
    assert stack_key("dec.0.xattn.wk") == "dec.xattn.wk"
    for own in ("enc_norm.scale", "patch_proj", "embed.tok", "final_norm"):
        assert stack_key(own) == own


def test_int8_state_of_encdec_layers_matches_jax():
    """Two int8 updates of reduced whisper-small's params from the JAX
    package's initial state with the same numpy gradients: every encoder
    and decoder layer's q and scale equal the JAX package's stacked
    leaf's slice, bit for bit (its layers share one absmax a leaf)."""
    from repro.config import reduced as j_reduced
    from repro.configs import get_config as j_get_config
    from repro.runtime import init_train_state as j_init
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_from_numpy, train_state_from_numpy
    jcfg = j_reduced(j_get_config("whisper-small"))
    cfg = reduced(get_config("whisper-small"))
    kw = dict(lr=1e-2, weight_decay=0.1, opt_state_dtype="int8",
              param_dtype="float32", grad_clip=1e9)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = j_init(jax.random.PRNGKey(4), jcfg, jtcfg)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu")
    jparams, jopt = jstate.params, jstate.opt
    params, opt = state.params, state.opt
    rng = np.random.default_rng(6)
    for step in range(2):
        # layers of one leaf far apart in size: a per-layer absmax would
        # give each its own scale
        g_np = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * 3 * (
                np.arange(p.shape[0]).reshape((-1,) + (1,) * (p.ndim - 1))
                + 1.0 if p.ndim > 1 else 1.0)).astype(np.float32),
            jax.tree.map(np.asarray, jparams))
        grads = dict(lm_from_numpy(g_np, cfg, device="cpu")
                     .named_parameters())
        params, opt, _ = adamw_update({n: g.detach()
                                       for n, g in grads.items()},
                                      opt, params, tcfg, 1e-2)
        jparams, jopt, _ = jadamw.adamw_update(
            jax.tree.map(jnp.asarray, g_np), jopt, jparams, jtcfg,
            jnp.float32(1e-2))
        for moment in ("m", "v"):
            ours = getattr(opt, moment)
            theirs = getattr(jopt, moment)
            for stack in ("enc", "dec"):
                for i in range(2):
                    for name in ("attn.wq", "mlp.w_up", "norm1.scale"):
                        leaf = theirs[stack]
                        for part in name.split("."):
                            leaf = leaf[part]
                        q = ours[f"{stack}.{i}.{name}"]
                        assert np.array_equal(q.q.numpy(),
                                              np.asarray(leaf.q)[i])
                        assert q.scale.numpy().tobytes() == np.asarray(
                            leaf.scale, np.float32).tobytes()
