"""The port's encoder-decoder (``repro_torch.models.encdec``) against
``repro.models.encdec`` on ``reduced(whisper-small)`` (2 encoder and 2
decoder layers, ``enc_seq`` 64, GQA 4 / 2), with the JAX params carried
across by ``repro_torch.convert.lm_from_numpy``.

Frames and tokens come from numpy with a fixed seed.  In float32,
encoder output and logits are held to 1e-4 (as ``test_torch_lm.py``
holds the decoder-only families) and the greedy tokens must be
identical; the port's own prefill + decode must reproduce its forward
to the 2e-3 that ``tests/test_models.py`` asks of the JAX package; the
loss within 1e-5 relative and every gradient within 1e-4 × max|g| of
``jax.grad``'s (as ``test_torch_train.py``).

Promotion: float32 frames under bfloat16 params, the training dtypes.
JAX promotes every einsum of the encoder to float32 (so the encoder
output and the prefill's cross keys / values are float32) while the
decoder's activations and its self-KV cache stay bfloat16; the port
must give the same dtypes.  Its float32 outputs are held to 1e-4 ×
their largest magnitude; its bfloat16 ones to 2^-6 × the largest, four
bf16 roundings (the two packages round their bfloat16 matmuls in other
orders; measured here: logits 5.5e-3, self keys 6.7e-3, cross keys
4.4e-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.models import api, encdec  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

ARCH = "whisper-small"
B, S, N_DEC = 2, 32, 4
N_PRE = S - N_DEC
TOL = 1e-4
BF16_REL = 2.0 ** -6


def _inputs(cfg, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    return toks, frames


@pytest.fixture(scope="module")
def su():
    """JAX params (float32), their port model, the inputs, and JAX's
    encode / decode_seq / prefill + N_DEC decode steps."""
    jcfg = j_reduced(j_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    params = jencdec.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    toks, frames = _inputs(jcfg)
    enc = jencdec.encode(params, jnp.asarray(frames), jcfg, remat="none")
    full = jencdec.decode_seq(params, jnp.asarray(toks), enc, jcfg,
                              remat="none")
    logits, caches = jencdec.prefill(params, jnp.asarray(toks[:, :N_PRE]),
                                     jnp.asarray(frames), jcfg,
                                     cache_cap=S)
    steps = [np.asarray(logits)]
    for i in range(N_DEC):
        logits, caches = jencdec.decode_step(
            params, jnp.asarray(toks[:, N_PRE + i:N_PRE + i + 1]),
            jnp.int32(N_PRE + i), caches, jcfg)
        steps.append(np.asarray(logits))
    model = lm_from_numpy(jax.tree.map(np.asarray, params), cfg,
                          device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, toks=toks,
                frames=frames, enc=np.asarray(enc), full=np.asarray(full),
                steps=steps)


def _port_decode(model, cfg, toks, frames):
    """The port's prefill over N_PRE tokens and N_DEC decode steps fed
    the true next tokens: (logits of each, caches)."""
    batch = {"tokens": torch.from_numpy(toks[:, :N_PRE]),
             "frames": torch.from_numpy(frames)}
    logits, caches = api.prefill(model, batch, cfg, cache_cap=S)
    steps = [logits]
    for i in range(N_DEC):
        logits, caches = api.decode_step(
            model, torch.from_numpy(toks[:, N_PRE + i:N_PRE + i + 1]),
            N_PRE + i, caches, cfg)
        steps.append(logits)
    return [s.numpy() for s in steps], caches


def _same_greedy(a, b):
    assert np.array_equal(np.argmax(a, -1), np.argmax(b, -1))


def test_model_names_and_init(su):
    """``EncDec`` holds the JAX tree's names, a layer per ModuleList
    entry, and ``init_params`` is seeded."""
    cfg = su["cfg"]
    model = api.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    again = api.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    assert isinstance(model, encdec.EncDec)
    assert len(model.enc) == cfg.n_enc_layers == 2
    assert len(model.dec) == cfg.n_layers == 2
    names = dict(model.named_parameters())
    for n in ("embed.tok", "embed.pos", "enc.1.norm1.scale", "enc.0.mlp.w_up",
              "enc_norm.bias", "dec.1.norm_x.scale", "dec.0.xattn.wq",
              "dec.1.attn.wo", "final_norm.scale"):
        assert n in names, n
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    for (n, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n


def test_encode_and_decode_seq_match_jax(su):
    model, cfg = su["model"], su["cfg"]
    with torch.no_grad():
        enc = encdec.encode(model, torch.from_numpy(su["frames"]), cfg,
                            remat="none")
        full = encdec.decode_seq(model, torch.from_numpy(su["toks"]), enc,
                                 cfg, remat="none")
        via_api = api.forward(model, {"tokens": torch.from_numpy(su["toks"]),
                                      "frames": torch.from_numpy(
                                          su["frames"])}, cfg)
    assert enc.shape == (B, cfg.enc_seq, cfg.d_model)
    assert np.abs(enc.numpy() - su["enc"]).max() < TOL
    assert full.shape == (B, S, cfg.vocab) and full.dtype == torch.float32
    assert np.abs(full.numpy() - su["full"]).max() < TOL
    _same_greedy(full.numpy(), su["full"])
    assert torch.equal(via_api, full)


def test_prefill_and_decode_match_jax(su):
    steps, caches = _port_decode(su["model"], su["cfg"], su["toks"],
                                 su["frames"])
    assert len(caches) == su["cfg"].n_layers
    assert set(caches[0]) == {"self", "xk", "xv"}
    for got, want in zip(steps, su["steps"]):
        assert np.abs(got - want).max() < TOL
        _same_greedy(got, want)


def test_prefill_decode_matches_own_forward(su):
    model, cfg = su["model"], su["cfg"]
    steps, _ = _port_decode(model, cfg, su["toks"], su["frames"])
    with torch.no_grad():
        full = api.forward(model, {"tokens": torch.from_numpy(su["toks"]),
                                   "frames": torch.from_numpy(su["frames"])},
                           cfg).numpy()
    errs = [np.abs(s - full[:, N_PRE - 1 + i]).max()
            for i, s in enumerate(steps[:-1])]
    assert max(errs) < 2e-3, errs


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_promotion_float32_frames_bf16_params():
    """float32 frames under bfloat16 params: the JAX package's output
    dtypes (encoder output and cross keys / values float32, self-KV and
    decoder bfloat16, logits float32) and its values."""
    jcfg = j_reduced(j_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    params = jencdec.init_params(jax.random.PRNGKey(1), jcfg, jnp.bfloat16)
    model = lm_from_numpy(jax.tree.map(np.asarray, params), cfg,
                          device="cpu")
    assert model.embed.tok.dtype == torch.bfloat16
    toks, frames = _inputs(jcfg, seed=9)
    j_enc = jencdec.encode(params, jnp.asarray(frames), jcfg, remat="none")
    j_logits, j_caches = jencdec.prefill(
        params, jnp.asarray(toks[:, :N_PRE]), jnp.asarray(frames), jcfg,
        cache_cap=S)
    j_step, _ = jencdec.decode_step(
        params, jnp.asarray(toks[:, N_PRE:N_PRE + 1]), jnp.int32(N_PRE),
        j_caches, jcfg)
    with torch.no_grad():
        enc = encdec.encode(model, torch.from_numpy(frames), cfg)
    logits, caches = encdec.prefill(model, torch.from_numpy(toks[:, :N_PRE]),
                                    torch.from_numpy(frames), cfg,
                                    cache_cap=S)
    # the JAX package's dtypes, as read here, and the port's
    assert j_enc.dtype == jnp.float32 and enc.dtype == torch.float32
    assert j_caches["xk"].dtype == jnp.float32
    assert j_caches["self"].k.dtype == jnp.bfloat16
    assert j_logits.dtype == jnp.float32
    for c in caches:
        assert c["xk"].dtype == c["xv"].dtype == torch.float32
        assert c["self"].k.dtype == c["self"].v.dtype == torch.bfloat16
    assert logits.dtype == torch.float32
    assert _rel(enc.numpy(), j_enc) < TOL
    for i, c in enumerate(caches):
        assert _rel(c["xk"].numpy(), j_caches["xk"][i]) < TOL, i
        assert _rel(c["xv"].numpy(), j_caches["xv"][i]) < TOL, i
        k = c["self"].k[:, :N_PRE].float().numpy()
        assert _rel(k, np.asarray(j_caches["self"].k[i, :, :N_PRE],
                                  np.float32)) < BF16_REL, i
    assert _rel(logits.numpy(), j_logits) < BF16_REL
    step, _ = encdec.decode_step(model, torch.from_numpy(
        toks[:, N_PRE:N_PRE + 1]), N_PRE, caches, cfg)
    assert step.dtype == torch.float32
    assert _rel(step.numpy(), j_step) < BF16_REL


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_gradients_match_jax(su, remat):
    jcfg, cfg, params = su["jcfg"], su["cfg"], su["params"]
    toks, frames = su["toks"], su["frames"]
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
              "frames": jnp.asarray(frames)}
    jl, jg = jax.value_and_grad(lambda p: jencdec.loss_fn(
        p, jbatch, jcfg, remat=remat))(params)
    model = lm_from_numpy(jax.tree.map(np.asarray, params), cfg,
                          device="cpu")
    want = dict(lm_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                              device="cpu").named_parameters())
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)}
    loss = api.loss_fn(model, batch, cfg, remat=remat)
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) / float(jl) - 1) < 1e-5
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        w = want[n].detach()
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), n


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


def test_remat_block_and_full_recompute_the_whole_layer(su):
    """The JAX package's encdec checkpoints a layer with no policy: under
    "block" as under "full" the backward runs every layer's products
    again (more ``mm``s than "none"); an unknown policy raises."""
    cfg = su["cfg"]
    batch = {"tokens": torch.from_numpy(su["toks"]),
             "labels": torch.from_numpy(su["toks"]),
             "frames": torch.from_numpy(su["frames"])}
    n = {r: _mm_calls_in_backward(su["model"], batch, cfg, r)
         for r in ("none", "block", "full")}
    assert n["none"] < n["block"] == n["full"], n
    with pytest.raises(ValueError, match="remat"):
        api.loss_fn(su["model"], batch, cfg, remat="some")


def test_all_true_cross_mask_plain_b5_equals_sdpa():
    """Cross-attention's mask is all true (no causal mask, no window, key
    positions arange(S_enc)): B5's plain version, non-causal without
    ``kv_len``, equals the decode step's ``_sdpa`` and JAX's ``_sdpa``
    on the same inputs, GQA included."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
    scale = 32 ** -0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                          tv.transpose(1, 2), causal=False,
                          scale=scale).transpose(1, 2)
    mask = torch.ones((7, 64), dtype=torch.bool)
    sdpa = A._sdpa(tq, tk, tv, mask, scale)
    want = JA._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.ones((7, 64), bool), scale)
    assert float((plain - sdpa).abs().max()) < 1e-6
    assert np.abs(plain.numpy() - np.asarray(want)).max() < 1e-6


def test_positions_past_the_learned_table_raise(su):
    """JAX clamps a gather past the learned position table; the port
    raises instead (on the card the gather would fault)."""
    model, cfg = su["model"], su["cfg"]
    caches = api.init_decode_caches(cfg, 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="learned table"):
        api.decode_step(model, torch.zeros((1, 1), dtype=torch.long),
                        cfg.max_seq, caches, cfg)
    enc = torch.zeros((1, cfg.enc_seq, cfg.d_model))
    with pytest.raises(ValueError, match="learned table"):
        encdec.decode_seq(model, torch.zeros((1, cfg.max_seq + 1),
                                             dtype=torch.long), enc, cfg)


def test_init_decode_caches_match_jax_shapes_and_dtypes(su):
    jc = jencdec.init_decode_caches(su["jcfg"], 2, 16, jnp.bfloat16)
    caches = api.init_decode_caches(su["cfg"], 2, 16, device="cpu")
    assert len(caches) == jc["xk"].shape[0]
    for c in caches:
        assert tuple(c["xk"].shape) == jc["xk"].shape[1:]
        assert tuple(c["self"].k.shape) == jc["self"].k.shape[1:]
        assert c["xk"].dtype == c["self"].k.dtype == torch.bfloat16
        assert bool((c["self"].pos_map == -1).all())
