"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against
``repro.models.moe._apply_moe_dense`` on the same inputs, made with
numpy, and the JAX package's ``init_moe`` params carried across with
``convert._tensor``.

* float32: outputs within 1e-5 (sums of up to 256 products in another
  order; measured ≤ 1e-6 on outputs of magnitude ≤ 2.3), the routing
  (top-k, sorted order, keep mask, slots) equal;
* bfloat16: the routing equal and the outputs within 2^-5 · max|y|
  (measured ≤ 2^-6.7).  Not bit-equal, and why: ``jax.nn.silu`` in
  bf16 rounds ``sigmoid(g)`` and then ``g · sigmoid(g)``, where
  ``F.silu`` rounds once (ROADMAP C (g)), so 3–39 % of the activations
  differ by one or two bf16 ulps; the router's float32 product differs
  in the last bits (its sums run in another order); and 1 in 10^5 of the
  bf16 expert products rounds the other way.  The combine alone, given
  the same expert rows and routing, is bit-equal to the reference's
  scatter-add at k = 8 (``test_combine_is_the_reference_scatter_add``);
* at the published capacity factor 1.25 some pairs drop, and the port
  drops the same pairs into the same slots, at 4, 16 and kimi-k2's
  published 384 experts (the last at d 64 / d_ff 64: the port's
  backward writes a whole ``[E, d, f]`` zero gradient for each expert's
  ``w_up[i]``, 15.5 s at d 128 / d_ff 256);
* exact ties among router logits pick the lower expert index, as
  ``jax.lax.top_k``;
* ``capacity`` equals the reference's over a grid;
* gradients with respect to x and every weight within 1e-4 · max|g| of
  ``jax.grad``'s (float32);
* two runs under ``torch.use_deterministic_algorithms(True)`` give the
  same bits.

The reference's routing intermediates are not returned by
``_apply_moe_dense``; ``_jax_route`` computes them with the reference's
own lines (``repro/models/moe.py:70-84``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import _tensor  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import params_module  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' ops are too small to gain from intra-op
    threads, and under ``pytest -n`` a worker's threads spin against the
    other workers': the gradients of kimi-k2's 384 experts took 164 s
    under ``pytest -n 6`` on eight threads a worker against 5 s alone.
    The port runs this file on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the reduced configs: mixtral (4 experts, top-2), kimi-k2 with 16
# experts and its own top-8, where the order of the combine's adds
# decides the bf16 bits, and kimi-k2 at its published 384 experts top-8
CASES = {"mixtral": ("mixtral-8x7b", {}),
         "kimi-k8": ("kimi-k2-1t-a32b", dict(n_experts=16, top_k=8)),
         "kimi-384": ("kimi-k2-1t-a32b", dict(n_experts=384, top_k=8,
                                               d_model=64, d_ff=64))}
F32_TOL = 1e-5
BF16_REL = 2.0 ** -5
GRAD_REL = 1e-4


def _configs(case, **over):
    arch, base = CASES[case]
    over = dict(base, **over)
    return j_reduced(j_get_config(arch), **over), \
        reduced(get_config(arch), **over)


def _params(jcfg, dtype, seed=0):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    return p, params_module(moe.MoE(), **{
        k: _tensor(np.asarray(v)) for k, v in p.items()})


def _x(shape, seed=1, offset=0.0):
    """Seeded activations; ``offset`` adds one shared direction to every
    token, which skews the router toward some experts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x + offset * rng.standard_normal(shape[-1:]).astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _jax_route(p, xt, cfg):
    """The reference's routing, its own lines (moe.py:70-84)."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = (xt.astype(jnp.float32) @ p["wg"])
    topv, topi = jax.lax.top_k(logits, k)
    weights = jax.nn.softmax(topv, axis=-1)
    e_flat = topi.reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    seg_start = jnp.searchsorted(e_sorted, jnp.arange(e))
    pos_in_e = jnp.arange(t * k) - seg_start[e_sorted]
    cap = jmoe.capacity(cfg, t)
    keep = pos_in_e < cap
    slot = jnp.where(keep, e_sorted * cap + pos_in_e, e * cap)
    return dict(topi=topi, weights=weights, order=order, keep=keep,
                slot=slot, cap=cap)


def _same_route(r, want):
    assert r.cap == want["cap"]
    for name in ("topi", "order", "keep", "slot"):
        assert np.array_equal(getattr(r, name).numpy(),
                              np.asarray(want[name])), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_jax(case, dtype):
    jcfg, cfg = _configs(case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p, tp = _params(jcfg, jdt)
    x = _x((4, 64, cfg.d_model))
    want = _np(jmoe._apply_moe_dense(p, jnp.asarray(x, jdt), jcfg))
    with torch.no_grad():
        xt = torch.from_numpy(x).to(tdt)
        got = moe.apply_moe(tp, xt, cfg)
        r = moe.route(tp, xt.reshape(-1, cfg.d_model), cfg)
    assert got.dtype == tdt and got.shape == xt.shape
    _same_route(r, _jax_route(p, jnp.asarray(x, jdt).reshape(
        -1, cfg.d_model), jcfg))
    err = np.abs(_np(got) - want).max()
    if dtype == "float32":
        assert err < F32_TOL
    else:
        assert err <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("case", list(CASES))
def test_drops_at_published_capacity_as_jax(case):
    """capacity_factor 1.25 (the configs' own) and a router skewed by a
    shared direction in the activations: pairs drop, the same pairs in
    both packages, into the same slots, and the outputs agree."""
    jcfg, cfg = _configs(case, capacity_factor=1.25)
    assert get_config(CASES[case][0]).capacity_factor == 1.25
    p, tp = _params(jcfg, jnp.float32)
    x = _x((4, 64, cfg.d_model), seed=3, offset=1.0)
    want = np.asarray(jmoe._apply_moe_dense(p, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = moe.apply_moe(tp, torch.from_numpy(x), cfg).numpy()
        r = moe.route(tp, torch.from_numpy(x).reshape(-1, cfg.d_model),
                      cfg)
    jr = _jax_route(p, jnp.asarray(x).reshape(-1, cfg.d_model), jcfg)
    assert int((~r.keep).sum()) > 0
    _same_route(r, jr)
    assert np.abs(got - want).max() < F32_TOL
    # a dropped pair reaches the overflow row, and only a dropped pair
    e = cfg.n_experts
    assert np.array_equal(r.slot.numpy() == e * r.cap, ~r.keep.numpy())


def test_combine_is_the_reference_scatter_add():
    """At k = 8 in bf16, the same expert rows and routing combine to the
    reference's ``.at[tok_sorted].add(contrib)`` bit for bit; summing
    each token's contributions in descending expert order instead
    changes bits, so the order is what this holds."""
    jcfg, cfg = _configs("kimi-k8", capacity_factor=1.25)
    _, tp = _params(jcfg, jnp.float32)
    x = _x((2, 48, cfg.d_model), seed=5, offset=1.0)
    t, d, k = 96, cfg.d_model, cfg.top_k
    r = moe.route(tp, torch.from_numpy(x).reshape(t, d), cfg)
    assert int((~r.keep).sum()) > 0
    rng = np.random.default_rng(6)
    flat = rng.standard_normal((cfg.n_experts * r.cap + 1, d)).astype(
        np.float32)
    flat[-1] = 0
    tflat = torch.from_numpy(flat).bfloat16()
    with torch.no_grad():
        got = moe.combine(tflat, r)
    # the reference's combine (moe.py:105-109) on the same rows / route
    jflat = jnp.asarray(flat, jnp.bfloat16)
    order = jnp.asarray(r.order.numpy())
    slot = jnp.asarray(r.slot.numpy())
    w_sorted = jnp.asarray(r.weights.detach().numpy()).reshape(-1)[order]
    keep = jnp.asarray(r.keep.numpy())
    contrib = jflat[slot] * (w_sorted * keep).astype(jnp.bfloat16)[:, None]
    want = jnp.zeros((t, d), jnp.bfloat16).at[order // k].add(contrib)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    # descending expert order: other bits
    inv = np.argsort(r.order.numpy())
    rows = np.asarray(contrib.astype(jnp.float32))
    desc = torch.zeros((t, d), dtype=torch.bfloat16)
    by = np.argsort(-r.topi.numpy(), axis=-1)
    for j in range(k):
        idx = inv[np.arange(t) * k + by[:, j]]
        desc = desc + torch.from_numpy(rows[idx]).bfloat16()
    assert not torch.equal(desc, got)


def test_exact_ties_route_as_jax_top_k():
    """Router logits that tie exactly (duplicated columns of wg; small
    integer activations and eighths in wg, so every product and sum is
    exact in float32): the port picks the experts jax.lax.top_k does,
    the lower index first, for k = 2 and k = 8."""
    for case in CASES:
        jcfg, cfg = _configs(case)
        rng = np.random.default_rng(8)
        e, d = cfg.n_experts, cfg.d_model
        wg = rng.integers(-4, 5, (d, e)).astype(np.float32) / 8
        wg[:, 1] = wg[:, 0]
        wg[:, e - 1] = wg[:, 0]
        wg[:, 2] = wg[:, 3]
        xt = rng.integers(-3, 4, (64, d)).astype(np.float32)
        p = {"wg": torch.from_numpy(wg)}
        with torch.no_grad():
            r = moe.route(params_module(**p), torch.from_numpy(xt), cfg)
        logits = r.logits.numpy()
        assert np.array_equal(logits[:, 0], logits[:, 1])
        _, want = jax.lax.top_k(jnp.asarray(xt) @ jnp.asarray(wg),
                                cfg.top_k)
        assert np.array_equal(r.topi.numpy(), np.asarray(want))
        # the ties were at the cut: some token's k-th and (k+1)-th logits
        # are equal; with 4 and 16 experts some token chose one of a
        # tied pair and not the other (among 384 the pairs rank past the
        # cut, and the small-integer logits tie there on their own)
        top = -np.sort(-logits, axis=-1)
        assert (top[:, cfg.top_k - 1] == top[:, cfg.top_k]).any()
        tied_cut = [(a in row) != (b in row) for row in r.topi.tolist()
                    for a, b in ((0, 1), (0, e - 1), (2, 3))]
        assert any(tied_cut) or e == 384


@pytest.mark.parametrize("factor", [0.1, 1.0, 1.25, 4.0, 8.0, 48.0])
def test_capacity_matches_reference(factor):
    for k in (1, 2, 8):
        for e in (4, 8, 16, 384):
            jcfg, cfg = _configs("mixtral", n_experts=e, top_k=k,
                                 capacity_factor=factor)
            for t in (1, 7, 8, 64, 100, 2080, 16384):
                assert moe.capacity(cfg, t) == jmoe.capacity(jcfg, t)
    assert moe.capacity(get_config("mixtral-8x7b"), 16384) == 5120
    mix = get_config("mixtral-8x7b")
    check = dataclasses.replace(mix, capacity_factor=mix.n_experts
                                / mix.top_k)
    assert moe.capacity(check, 8) == 8 and moe.capacity(check, 2080) == 2080


def test_moe_routing_load_and_flops():
    """tests/test_models.py's test on the port: all top-k weight mass
    lands somewhere at generous capacity, and the per-token FLOPs
    estimate is the reference's."""
    _, cfg = _configs("mixtral")
    jcfg, _ = _configs("mixtral")
    _, tp = _params(jcfg, jnp.float32)
    x = torch.from_numpy(_x((2, 16, cfg.d_model), seed=11))
    with torch.no_grad():
        y = moe.apply_moe(tp, x, cfg)
        r = moe.route(tp, x.reshape(-1, cfg.d_model), cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert bool(r.keep.all())
    assert moe.capacity(cfg, 32) >= 32 * cfg.top_k // cfg.n_experts
    for arch in ("mixtral-8x7b", "kimi-k2-1t-a32b"):
        assert moe.moe_flops_per_token(get_config(arch)) == \
            jmoe.moe_flops_per_token(j_get_config(arch))


def test_moe_capacity_drops_tokens():
    """tests/test_models.py's test on the port: at capacity_factor ≪ 1
    tokens drop, and the output moves away from a generous run."""
    jcfg, cfg = _configs("mixtral")
    tight = dataclasses.replace(cfg, capacity_factor=0.1)
    _, tp = _params(jcfg, jnp.float32)
    x = torch.from_numpy(_x((2, 32, cfg.d_model), seed=12))
    with torch.no_grad():
        y_full = moe.apply_moe(tp, x, cfg)
        y_tight = moe.apply_moe(tp, x, tight)
    assert float((y_full - y_tight).abs().max()) > 1e-4
    assert bool(torch.isfinite(y_tight).all())


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case, capacity_factor):
    """d(Σ y·c)/d(x, wg, w_up, w_gate, w_down) against jax.grad of the
    reference, float32, with and without dropped pairs."""
    if capacity_factor == 8.0 and CASES[case][1].get("n_experts") == 384:
        # the skewed tokens crowd an expert of 384 past factor 8's 16
        # slots: no pair drops at E / k (capacity = T)
        capacity_factor = 384 / 8
    jcfg, cfg = _configs(case, capacity_factor=capacity_factor)
    p, tp = _params(jcfg, jnp.float32)
    x = _x((2, 32, cfg.d_model), seed=13, offset=1.0)
    c = np.random.default_rng(14).standard_normal(x.shape).astype(
        np.float32)

    def j_loss(p, x):
        return jnp.sum(jmoe._apply_moe_dense(p, x, jcfg) * c)

    gp, gx = jax.grad(j_loss, argnums=(0, 1))(p, jnp.asarray(x))
    with torch.no_grad():
        r = moe.route(tp, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg)
    assert bool(r.keep.all()) == (capacity_factor != 1.25)
    tx = torch.from_numpy(x).requires_grad_()
    loss = (moe.apply_moe(tp, tx, cfg) * torch.from_numpy(c)).sum()
    names, ps = zip(*tp.named_parameters())
    grads = torch.autograd.grad(loss, (tx,) + ps)
    assert set(names) == set(gp)
    for name, g, w in zip(("x",) + names, grads,
                          (gx,) + tuple(gp[n] for n in names)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max(), \
            name


def test_deterministic_algorithms_give_the_same_bits():
    jcfg, cfg = _configs("kimi-k8", capacity_factor=1.25)
    _, tp = _params(jcfg, jnp.bfloat16)
    x = torch.from_numpy(_x((2, 32, cfg.d_model), seed=15,
                            offset=1.0)).bfloat16()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            a = moe.apply_moe(tp, x, cfg)
            b = moe.apply_moe(tp, x, cfg)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
