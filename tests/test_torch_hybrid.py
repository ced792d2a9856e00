"""The hybrid family (jamba-1.5-large at ``reduced()``: one period of 8
layers — seven SSM mixers and one attention layer at offset 4, an MLP
or, every second layer, a mixture of 4 experts) against the JAX
package on the CPU, at one period and at two (``n_layers=16``, which
stacks two groups under ``groups`` in the JAX param tree), in float32
with the JAX params carried across by ``repro_torch.convert``:

* forward, prefill and 4 decode steps: logits within 1e-4 and the same
  greedy tokens (``tests/test_torch_lm.py``'s rule), and the port's
  decode within 2e-3 of its own forward;
* the loss within 1e-5 relative and every parameter's gradient within
  1e-4 × max|g| of ``jax.grad``'s (``tests/test_torch_train.py``'s
  rule), under each ``remat``, masked and not, against the JAX
  package's gradient under remat "none" (its "block" and "full" read
  within 6.2e-6 × max|g| of it on every leaf, and each compiles a
  program of its own); at two periods a leaf past the rule is held to a
  float64 gradient instead (``F32_GRAD_NOISE``);
* on a mesh, training, prefill and decode pass the mesh gate (they run
  on a mesh in ``tests/test_torch_expert_parallel.py``).

The train steps, the optimizer state and the checkpoints of the family
are ``tests/test_torch_hybrid_train.py``'s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_from_numpy  # noqa: E402
from repro_torch.models import api, blocks  # noqa: E402

ARCH = "jamba-1.5-large-398b"
# one period (8 layers) and two (16: the JAX package stacks two groups)
PERIODS = {"1period": 8, "2periods": 16}
B, S, N_DEC = 2, 32, 4
N_PRE = S - N_DEC
TOL = 1e-4
# At two periods (16 layers, 14 of them SSM mixers) the float32
# rounding of each package's gradient reaches 1e-4 × max|g| on the SSM's
# small leaves: against the port's float64 gradient of the same inputs
# (masked loss, remat "none"), JAX's float32 gradient read up to 1.20e-4
# × max|g| of its leaf and the port's 9.7e-5; the two float32 gradients
# of ``groups.1.l3.ssm.A_log`` part by 1.11e-4.  A leaf that the
# float32 rule does not pass is held instead to that float64 gradient:
# both packages' float32 gradients within F32_GRAD_NOISE × max|g|.  A
# fault in the port moves its float64 gradient too, and JAX's then
# fails this.
F32_GRAD_NOISE = 1.5e-4


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


def _batch(toks, mask=None, lib=torch.from_numpy):
    b = {"tokens": lib(toks), "labels": lib(toks)}
    if mask is not None:
        b["mask"] = lib(mask)
    return b


@pytest.fixture(scope="module")
def params():
    """The JAX package's float32 params at each depth."""
    out = {}
    for name, n in PERIODS.items():
        jcfg, cfg = _configs(n)
        out[name] = (jcfg, cfg, japi.init_params(jax.random.PRNGKey(0),
                                                 jcfg, jnp.float32))
    return out


def test_reduced_period_holds_every_layer_kind():
    """A group is one period: attention at offset 4, SSM elsewhere, a
    MoE every second layer; the caches follow the mixers."""
    _, cfg = _configs(16)
    kinds = blocks.layer_kinds(cfg)
    assert kinds == [("ssm", "mlp"), ("ssm", "moe"), ("ssm", "mlp"),
                     ("ssm", "moe"), ("attn", "mlp"), ("ssm", "moe"),
                     ("ssm", "mlp"), ("ssm", "moe")]
    assert blocks.n_groups(cfg) == 2
    model = api.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    assert len(model.groups) == 2
    caches = api.init_decode_caches(cfg, 1, 8, torch.float32, "cpu")
    assert len(caches) == 2
    attn_cache = type(caches[0]["l4"])
    assert all((type(c[f"l{i}"]) is attn_cache) == (m == "attn")
               for c in caches for i, (m, _) in enumerate(kinds))


@pytest.mark.parametrize("depth", sorted(PERIODS))
def test_forward_prefill_decode_match_jax(params, depth):
    jcfg, cfg, jp = params[depth]
    toks = _tokens(jcfg.vocab, (B, S), 7)
    full_j = np.asarray(japi.forward(jp, {"tokens": jnp.asarray(toks)},
                                     jcfg))
    logits, caches = japi.prefill(jp, {"tokens": jnp.asarray(toks[:, :N_PRE])},
                                  jcfg, cache_cap=S)
    steps_j = [np.asarray(logits)]
    for i in range(N_DEC):
        logits, caches = japi.decode_step(
            jp, jnp.asarray(toks[:, N_PRE + i:N_PRE + i + 1]),
            jnp.int32(N_PRE + i), caches, jcfg)
        steps_j.append(np.asarray(logits))

    model = lm_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    with torch.no_grad():
        full = api.forward(model, {"tokens": torch.from_numpy(toks)},
                           cfg).numpy()
    logits, caches = api.prefill(
        model, {"tokens": torch.from_numpy(toks[:, :N_PRE])}, cfg,
        cache_cap=S)
    steps = [logits.numpy()]
    for i in range(N_DEC):
        logits, caches = api.decode_step(
            model, torch.from_numpy(toks[:, N_PRE + i:N_PRE + i + 1]),
            N_PRE + i, caches, cfg)
        steps.append(logits.numpy())

    assert full.shape == (B, S, cfg.vocab) and full.dtype == np.float32
    assert np.abs(full - full_j).max() < TOL
    assert np.array_equal(full.argmax(-1), full_j.argmax(-1))
    for got, want in zip(steps, steps_j):
        assert np.abs(got - want).max() < TOL
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
    errs = [np.abs(s - full[:, N_PRE - 1 + i]).max()
            for i, s in enumerate(steps)]
    assert max(errs) < 2e-3, errs


@pytest.fixture(scope="module")
def jax_grads(params):
    """The JAX package's loss and gradients (remat "none") per depth and
    mask, the port's model, and the batch (numpy)."""
    cache = {}

    def get(depth, masked):
        if (depth, masked) not in cache:
            jcfg, cfg, jp = params[depth]
            toks = _tokens(jcfg.vocab, (2, 64), 1)
            mask = ((np.random.default_rng(2).random((2, 64)) < 0.7)
                    .astype(np.int32) if masked else None)
            jl, jg = jax.value_and_grad(lambda p: japi.loss_fn(
                p, _batch(toks, mask, jnp.asarray), jcfg, remat="none"))(jp)
            want = dict(lm_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                                      device="cpu").named_parameters())
            cache[depth, masked] = (float(jl), want, toks, mask)
        return cache[depth, masked]
    return get


@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
@pytest.mark.parametrize("remat", ["none", "block", "full"])
@pytest.mark.parametrize("depth", sorted(PERIODS))
def test_loss_and_gradients_match_jax(params, jax_grads, depth, remat,
                                      masked):
    _, cfg, jp = params[depth]
    jl, want, toks, mask = jax_grads(depth, masked)
    model = lm_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    loss = api.loss_fn(model, _batch(toks, mask), cfg, remat=remat)
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) / jl - 1) < 1e-5
    names, ps = zip(*model.named_parameters())
    exact = None
    for n, g in zip(names, torch.autograd.grad(loss, ps)):
        w = want[n].detach()
        scale = float(w.abs().max())
        if float((g - w).abs().max()) <= 1e-4 * scale:
            continue
        assert depth == "2periods", n
        if exact is None:
            exact = _float64_gradients(model, _batch(toks, mask), cfg, remat)
        for got in (g, w):
            assert float((got.double() - exact[n]).abs().max()) <= \
                F32_GRAD_NOISE * scale, n


def _float64_gradients(model, batch, cfg, remat):
    """The port's gradients of the same loss with every parameter in
    float64 (the plain SSD scan and attention then run in float64)."""
    import copy
    exact = copy.deepcopy(model).double()
    loss = api.loss_fn(exact, batch, cfg, remat=remat)
    names, ps = zip(*exact.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, ps)))


def test_hybrid_training_prefill_and_decode_pass_the_mesh_gate():
    """Off a mesh the family runs; on one, training, prefill and decode
    pass the mesh gate (they run on 8 processes in
    ``tests/test_torch_expert_parallel.py``)."""
    _, cfg = _configs(8)
    model = api.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, "cpu")
    batch = _batch(_tokens(cfg.vocab, (2, 16), 0))
    assert torch.isfinite(api.loss_fn(model, batch, cfg))
    mesh = sharding.AbstractMesh((4, 2), ("data", "model"))
    with sharding.mesh_context(mesh):
        for what in ("training", "prefill", "decode"):
            api.check_lm_mesh(cfg, what)
