"""The port's decoder-only LM (``repro_torch.models``) against
``repro.models`` on ``reduced()`` configs, in float32, with the JAX
params carried across by ``repro_torch.convert.lm_from_numpy``.

Tokens (and internvl2's patch embeddings, as ``tests/test_models.py``
makes them) come from numpy with a fixed seed; internvl2 decodes at
absolute positions past its 16 patches.  Logits are held to 1e-4
(float32 through two layers; the two packages round matmuls and
transcendental functions differently, measured ≤ 5e-6 on logits of
magnitude ≤ 5), and the greedy tokens must be identical.  The port's own
prefill + decode must reproduce its forward to the 2e-3 that
``tests/test_models.py`` asks of the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_from_numpy  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' ops are too small to gain from intra-op
    threads, and under ``pytest -n`` a worker's threads spin against the
    other workers': kimi-k2's 384 experts, one small product after
    another, took 368 s under ``pytest -n 6`` on eight threads a worker
    against 11 s alone.  The port runs this file on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, S, N_DEC = 2, 32, 4
N_PRE = S - N_DEC
TOL = 1e-4
PORTED = ["smollm-360m", "olmo-1b", "gemma-2b", "glm4-9b", "mamba2-130m",
          "mixtral-8x7b", "kimi-k2-1t-a32b", "internvl2-1b"]


def _setup(arch, impl="xla", **over):
    """JAX params / logits and the port's model for one reduced arch:
    forward over S tokens, prefill over the first N_PRE, N_DEC decode
    steps fed the true next tokens (vlm: after the patches, at absolute
    positions ``n_patches`` + N_PRE + i)."""
    jcfg = j_reduced(j_get_config(arch), **over)
    cfg = reduced(get_config(arch), **over)
    params = japi.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    extra, off = {}, 0
    if jcfg.family == "vlm":
        extra = {"patches": rng.standard_normal(
            (B, jcfg.n_patches, jcfg.d_model)).astype(np.float32)}
        off = jcfg.n_patches
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    full = np.asarray(japi.forward(
        params, {"tokens": jnp.asarray(toks), **jextra}, jcfg, impl=impl))
    logits, caches = japi.prefill(
        params, {"tokens": jnp.asarray(toks[:, :N_PRE]), **jextra}, jcfg,
        cache_cap=off + S, impl=impl)
    steps = [np.asarray(logits)]
    for i in range(N_DEC):
        logits, caches = japi.decode_step(
            params, jnp.asarray(toks[:, N_PRE + i:N_PRE + i + 1]),
            jnp.int32(off + N_PRE + i), caches, jcfg)
        steps.append(np.asarray(logits))
    model = lm_from_numpy(jax.tree.map(np.asarray, params), cfg,
                          device="cpu")
    return dict(cfg=cfg, params=params, toks=toks, full=full, steps=steps,
                model=model, extra=extra, off=off)


@pytest.fixture(scope="module")
def setups():
    cache = {}

    def get(arch, impl="xla"):
        if (arch, impl) not in cache:
            cache[arch, impl] = _setup(arch, impl)
        return cache[arch, impl]
    return get


def _port_run(su):
    model, cfg, toks, off = su["model"], su["cfg"], su["toks"], su["off"]
    extra = {k: torch.from_numpy(v) for k, v in su["extra"].items()}
    with torch.no_grad():
        full = api.forward(model, {"tokens": torch.from_numpy(toks),
                                   **extra}, cfg)
    logits, caches = api.prefill(
        model, {"tokens": torch.from_numpy(toks[:, :N_PRE]), **extra}, cfg,
        cache_cap=off + S)
    steps = [logits]
    for i in range(N_DEC):
        logits, caches = api.decode_step(
            model, torch.from_numpy(toks[:, N_PRE + i:N_PRE + i + 1]),
            off + N_PRE + i, caches, cfg)
        steps.append(logits)
    return full.numpy(), [s.numpy() for s in steps]


def _same_greedy(a, b):
    assert np.array_equal(np.argmax(a, -1), np.argmax(b, -1))


@pytest.mark.parametrize("arch", PORTED)
def test_forward_prefill_decode_match_jax(setups, arch):
    su = setups(arch)
    full, steps = _port_run(su)
    assert full.shape == (B, S, su["cfg"].vocab) and full.dtype == np.float32
    assert np.abs(full - su["full"]).max() < TOL
    _same_greedy(full, su["full"])
    for got, want in zip(steps, su["steps"]):
        assert np.abs(got - want).max() < TOL
        _same_greedy(got, want)


@pytest.mark.parametrize("arch", ["smollm-360m", "internvl2-1b"])
def test_matches_jax_pallas_path(setups, arch):
    """The JAX package's Pallas attention (interpret mode) is the
    function the port's attention kernel replaces (internvl2: GQA group
    2, over patches and tokens)."""
    su = setups(arch, "pallas")
    full, steps = _port_run(su)
    assert np.abs(full - su["full"]).max() < TOL
    for got, want in zip(steps, su["steps"]):
        assert np.abs(got - want).max() < TOL
        _same_greedy(got, want)


# the dense configurations at their published head layouts (``reduced``
# gives every model 4 query heads of 32): gemma-2b's MQA at head_dim 256
# (GeGLU, tied table), olmo-1b's MHA (the non-parametric LayerNorm),
# glm4-9b's GQA 32 / 2 as 8 / 2 (untied); gemma-2b's also through the
# JAX package's Pallas attention in interpret mode; kimi-k2's published
# expert layout (384 experts top-8) with its 8:1 grouping at head_dim 112
# as 8 / 1, through both attentions
KIMI_PUBLISHED = dict(n_heads=8, n_kv_heads=1, head_dim=112, n_experts=384,
                      top_k=8)
PUBLISHED_HEADS = [
    ("gemma-2b", "xla", dict(n_heads=8, n_kv_heads=1, head_dim=256)),
    ("olmo-1b", "xla", dict(n_heads=4, n_kv_heads=4)),
    ("glm4-9b", "xla", dict(n_heads=8, n_kv_heads=2)),
    ("gemma-2b", "pallas", dict(n_heads=8, n_kv_heads=1, head_dim=256)),
    ("kimi-k2-1t-a32b", "xla", KIMI_PUBLISHED),
    ("kimi-k2-1t-a32b", "pallas", KIMI_PUBLISHED),
]


@pytest.mark.parametrize("arch,impl,over", PUBLISHED_HEADS,
                         ids=[f"{a}-{i}" for a, i, _ in PUBLISHED_HEADS])
def test_published_head_layouts_match_jax(arch, impl, over):
    su = _setup(arch, impl, **over)
    cfg = su["cfg"]
    assert (cfg.n_heads, cfg.n_kv_heads) == (over["n_heads"],
                                             over["n_kv_heads"])
    assert cfg.hd() == over.get("head_dim", 32)
    full, steps = _port_run(su)
    assert np.abs(full - su["full"]).max() < TOL
    _same_greedy(full, su["full"])
    for got, want in zip(steps, su["steps"]):
        assert np.abs(got - want).max() < TOL
        _same_greedy(got, want)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_decode_matches_own_forward(setups, arch):
    full, steps = _port_run(setups(arch))
    errs = [np.abs(s - full[:, N_PRE - 1 + i]).max()
            for i, s in enumerate(steps[:-1])]
    assert max(errs) < 2e-3, errs


def test_swa_ring_buffer_decode():
    """Sliding-window cache (mirrors tests/test_models.py's ring-buffer
    test on a dense config): decode past the window matches the port's
    forward and the JAX package's decode."""
    over = dict(window=16, max_seq=512)
    jcfg = j_reduced(j_get_config("smollm-360m"), **over)
    cfg = reduced(get_config("smollm-360m"), **over)
    params = japi.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    model = lm_from_numpy(jax.tree.map(np.asarray, params), cfg,
                          device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 48)) \
        .astype(np.int32)
    with torch.no_grad():
        full = api.forward(model, {"tokens": torch.from_numpy(toks)},
                           cfg).numpy()
    n_pre = 40
    logits, caches = api.prefill(
        model, {"tokens": torch.from_numpy(toks[:, :n_pre])}, cfg,
        cache_cap=48)
    assert caches[0]["l0"].cap == 16
    jl, jc = japi.prefill(params, {"tokens": jnp.asarray(toks[:, :n_pre])},
                          jcfg, cache_cap=48)
    errs = [np.abs(logits.numpy() - full[:, n_pre - 1]).max()]
    for i in range(48 - n_pre - 1):
        tok = toks[:, n_pre + i:n_pre + i + 1]
        logits, caches = api.decode_step(model, torch.from_numpy(tok),
                                         n_pre + i, caches, cfg)
        jl, jc = japi.decode_step(params, jnp.asarray(tok),
                                  jnp.int32(n_pre + i), jc, jcfg)
        errs.append(np.abs(logits.numpy() - full[:, n_pre + i]).max())
        assert np.abs(logits.numpy() - np.asarray(jl)).max() < TOL
    assert np.array_equal(caches[0]["l0"].pos_map.numpy(),
                          np.asarray(jc["l0"].pos_map[0]))
    assert max(errs) < 2e-3, errs


@pytest.mark.parametrize("arch,over", [
    ("kimi-k2-1t-a32b", dict(n_experts=16, top_k=8)),
    ("mixtral-8x7b", dict(capacity_factor=1.25)),
    ("kimi-k2-1t-a32b", dict(n_experts=16, top_k=8, capacity_factor=1.25)),
], ids=["kimi-k8", "mixtral-drop", "kimi-k8-drop"])
def test_moe_lm_matches_jax(arch, over):
    """The whole reduced MoE LM — forward, prefill and decode — against
    the JAX package's at kimi-k2's own top-8 (reduced() cuts it to 2)
    and at the configs' published capacity factor 1.25, where the
    forward drops pairs (counted through forward hooks on the port's
    MoE modules)."""
    su = _setup(arch, **over)
    drops = []

    def count(module, args, out):
        x = args[0]
        r = moe.route(module, x.reshape(-1, x.shape[-1]), su["cfg"])
        drops.append(int((~r.keep).sum()))
    hooks = [m.register_forward_hook(count) for m in su["model"].modules()
             if isinstance(m, moe.MoE)]
    try:
        full, steps = _port_run(su)
    finally:
        for h in hooks:
            h.remove()
    assert len(drops) == su["cfg"].n_layers * (2 + N_DEC)
    if su["cfg"].capacity_factor == 1.25:
        assert sum(drops) > 0
    assert np.abs(full - su["full"]).max() < TOL
    _same_greedy(full, su["full"])
    for got, want in zip(steps, su["steps"]):
        assert np.abs(got - want).max() < TOL
        _same_greedy(got, want)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m",
                                  "mixtral-8x7b"])
def test_bf16_params_carry_across_bit_for_bit(arch):
    """JAX exports bfloat16 as ml_dtypes.bfloat16, which torch cannot
    take; the converter carries the bits across unchanged and keeps the
    float32 SSM params and the float32 MoE router float32."""
    jcfg = j_reduced(j_get_config(arch))
    params = japi.init_params(jax.random.PRNGKey(2), jcfg, jnp.bfloat16)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    model = lm_from_numpy(jax.tree.map(np.asarray, params),
                          reduced(get_config(arch)), device="cpu")
    own = dict(model.named_parameters())
    for path, leaf in flat:
        keys = [p.key for p in path]
        arr = np.asarray(leaf)
        for g in range(arr.shape[0] if keys[0] == "groups" else 1):
            name = ".".join([keys[0]] + ([str(g)] if keys[0] == "groups"
                                         else []) + keys[1:])
            want = arr[g] if keys[0] == "groups" else arr
            got = own[name].detach()
            assert str(got.dtype).endswith(want.dtype.name), name
            bits = torch.int16 if want.itemsize == 2 else torch.int32
            assert np.array_equal(got.view(bits).numpy(),
                                  want.view(f"i{want.itemsize}")), name


def test_converter_rejects_a_mismatched_tree():
    jcfg = j_reduced(j_get_config("smollm-360m"))
    cfg = reduced(get_config("smollm-360m"))
    tree = jax.tree.map(np.asarray, japi.init_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32))
    del tree["final_norm"]["scale"]
    with pytest.raises(ValueError, match="param names differ"):
        lm_from_numpy(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, japi.init_params(
        jax.random.PRNGKey(0), j_reduced(j_get_config("smollm-360m"),
                                         d_ff=128), jnp.float32))
    with pytest.raises(ValueError, match="shape"):
        lm_from_numpy(tree, cfg, device="cpu")


def test_init_params_is_seeded_and_keeps_the_jax_dtypes():
    cfg = reduced(get_config("mamba2-130m"))
    a = api.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = api.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    dtypes = {n: p.dtype for n, p in a.named_parameters()}
    assert dtypes["groups.0.l0.ssm.A_log"] == torch.float32
    assert dtypes["groups.0.l0.ssm.D"] == torch.float32
    assert dtypes["groups.0.l0.ssm.dt_bias"] == torch.float32
    assert dtypes["groups.0.l0.ssm.in_proj"] == torch.bfloat16
    assert dtypes["embed.tok"] == torch.bfloat16
    assert len(a.groups) == cfg.n_layers
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


# ---------------------------------------------------------------------------
# bf16 decode drift against a fresh forward, both packages
# ---------------------------------------------------------------------------

DRIFT_B, DRIFT_PROMPT, DRIFT_STEPS = 4, 64, 32
# the port may drift from its fresh forward by no more than the JAX
# package does, plus one bf16 rounding of the largest logit (2^-8
# relative); its greedy decode may disagree with its forward on at most
# one token more than the JAX package's of the 4 × 33 compared
DRIFT_RTOL = 2.0 ** -8
DRIFT_TOKENS = 1


def _drift(prefill, decode, forward, toks):
    """Prefill ``toks``, then DRIFT_STEPS greedy decode steps; a fresh
    forward over prompt + generated tokens.  Returns (max over steps of
    max |Δ logit| / max |logit| of the step, the count of greedy tokens
    where decode and forward disagree, the tokens compared)."""
    logits, caches = prefill(toks)
    out, steps = [np.argmax(logits, -1)], [logits]
    for i in range(DRIFT_STEPS):
        logits, caches = decode(out[-1][:, None], DRIFT_PROMPT + i, caches)
        out.append(np.argmax(logits, -1))
        steps.append(logits)
    gen = np.stack(out, 1)
    full = forward(np.concatenate([toks, gen[:, :DRIFT_STEPS]], 1))
    rel = max(float(np.abs(s - full[:, DRIFT_PROMPT - 1 + i]).max()
                    / np.abs(full[:, DRIFT_PROMPT - 1 + i]).max())
              for i, s in enumerate(steps))
    miss = int((np.argmax(full[:, DRIFT_PROMPT - 1:], -1) != gen).sum())
    return rel, miss, gen.size


def test_bf16_decode_drift_matches_jax():
    """mamba2's bf16 decode against a fresh bf16 forward over the same
    tokens, at the reduced size (2 layers, d_model 128), the same bf16
    weights in both packages: the port drifts no farther than the JAX
    package (``DRIFT_RTOL``, ``DRIFT_TOKENS``).  Measured here: JAX
    9.4e-3 (every greedy token agreeing), the port 0 (its decode gives
    its forward's logits bit for bit on the CPU)."""
    jcfg = j_reduced(j_get_config("mamba2-130m"))
    cfg = reduced(get_config("mamba2-130m"))
    params = japi.init_params(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab, (DRIFT_B, DRIFT_PROMPT)).astype(np.int32)
    cap = DRIFT_PROMPT + DRIFT_STEPS

    def f32(x):
        return np.asarray(x.astype(jnp.float32))

    def j_prefill(t):
        logits, caches = japi.prefill(params, {"tokens": jnp.asarray(t)},
                                      jcfg, cache_cap=cap)
        return f32(logits), caches

    def j_decode(tok, pos, caches):
        logits, caches = japi.decode_step(params, jnp.asarray(tok),
                                          jnp.int32(pos), caches, jcfg)
        return f32(logits), caches

    def j_forward(t):
        return f32(japi.forward(params, {"tokens": jnp.asarray(t)}, jcfg))

    model = lm_from_numpy(jax.tree.map(np.asarray, params), cfg,
                          device="cpu")
    assert model.embed.tok.dtype == torch.bfloat16

    def p_prefill(t):
        logits, caches = api.prefill(model, {"tokens": torch.from_numpy(t)},
                                     cfg, cache_cap=cap)
        return logits.float().numpy(), caches

    def p_decode(tok, pos, caches):
        logits, caches = api.decode_step(model, torch.from_numpy(tok), pos,
                                         caches, cfg)
        return logits.float().numpy(), caches

    def p_forward(t):
        return api.forward(model, {"tokens": torch.from_numpy(t)},
                           cfg).float().numpy()

    j_rel, j_miss, n = _drift(j_prefill, j_decode, j_forward, toks)
    with torch.no_grad():
        p_rel, p_miss, _ = _drift(p_prefill, p_decode, p_forward, toks)
    assert n == DRIFT_B * (DRIFT_STEPS + 1)
    assert p_rel <= j_rel + DRIFT_RTOL, (p_rel, j_rel)
    assert p_miss <= j_miss + DRIFT_TOKENS, (p_miss, j_miss)
