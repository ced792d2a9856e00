"""The port's flash-attention (plain version on the CPU, the autograd
wrapper, the operand checks) and its attention layer against
``repro.kernels.flash_attention`` and ``repro.models.attention``.

Inputs come from numpy with fixed seeds and go through both packages.
The JAX side runs the Pallas kernel in interpret mode and the jnp
reference ``attention_ref``.  Tolerances are the JAX tests' own
(``tests/test_kernels.py::TestFlashAttention``): 3e-5 in float32 (sums
of up to 100 products in another order) and 3e-2 in bfloat16 (the
output is rounded to bfloat16, whose ulp at |o| < 4 is at most 2^-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.flash_attention import attention_ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402,E501
from repro.models import attention as JA  # noqa: E402
from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import _tensor  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_attention,
                                                 flash_attention_fwd)
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.layers import params_module  # noqa: E402

SHAPES = [(2, 4, 2, 64, 64, 32, True, None),
          (1, 4, 1, 64, 64, 16, True, 24),
          (1, 2, 2, 40, 72, 32, False, None),
          (1, 1, 1, 100, 100, 8, True, 16)]


def _qkv(dtype, b, hq, hkv, sq, skv, d, seed=42):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.standard_normal(s), dtype=dtype)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d),
                           (b, hkv, skv, d)))


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", SHAPES)
def test_plain_matches_jax_kernel_and_ref(dtype, b, hq, hkv, sq, skv, d,
                                          causal, window):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v = _qkv(jdt, b, hq, hkv, sq, skv, d)
    want_kernel = j_flash(q, k, v, causal, window, None, 16, 16, True)
    want_ref = j_ref(q, k, v, causal=causal, window=window, scale=d ** -0.5)
    tq, tk, tv = (_tensor(np.asarray(x)) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal, window)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    tol = 3e-5 if dtype == "float32" else 3e-2
    assert np.abs(_np32(got) - _np32(want_kernel)).max() < tol
    assert np.abs(_np32(got) - _np32(want_ref)).max() < tol


@pytest.mark.parametrize("kv_len", [0, 17, 72])
def test_kv_len_padding_matches_jax_ref(kv_len):
    """Keys at and past kv_len are masked; a row that sees no key is 0."""
    q, k, v = _qkv(jnp.float32, 1, 2, 1, 40, 72, 32, seed=3)
    want = j_ref(q, k, v, causal=False, scale=0.25, kv_len=kv_len)
    got = flash_attention(*(_tensor(np.asarray(x)) for x in (q, k, v)),
                          False, None, 0.25, kv_len)
    assert np.abs(_np32(got) - _np32(want)).max() < 3e-5
    if kv_len == 0:
        assert not got.any()


def test_autograd_backward_is_the_plain_version(monkeypatch):
    """The kernel's autograd.Function differentiates through the plain
    version (the JAX package's custom_vjp).  The launch is swapped for
    the plain forward, since the CPU has no kernel; gradients must match
    JAX's gradient of its reference (the JAX test's 1e-4)."""
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((1, 2, 32, 16)).astype(np.float32)
            for _ in range(3)]

    def j_loss(q, k, v):
        return jnp.sum(j_ref(q, k, v, causal=True, scale=16 ** -0.5) ** 2)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    monkeypatch.setattr(
        FA, "flash_attention_fwd",
        lambda q, k, v, causal, window, scale, kv_len: attention_ref(
            q, k, v, causal=causal, window=window, scale=scale,
            kv_len=kv_len))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = FA._FlashAttention.apply(*ts, True, None, 16 ** -0.5, None)
    (out ** 2).sum().backward()
    for t, w in zip(ts, want):
        assert np.abs(t.grad.numpy() - np.asarray(w)).max() < 1e-4


def test_kernel_launch_refuses_what_it_cannot_take():
    """A launch is refused (never falls back) for tensors off the card
    and for a dtype the kernel has no instance of."""
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_fwd(q, q, q, True, None, 0.125, None)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_fwd(q.half(), q.half(), q.half(), True, None, 1.0,
                            None)
    meta = torch.empty((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_fwd(meta, meta, meta, True, None, 1.0, None)
    assert FA.HEAD_DIMS == (64, 128, 256)
    with pytest.raises(ValueError, match="head_dim 320 > 256"):
        FA.pad_head_dim(torch.zeros((1, 2, 8, 320)))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_head_dim_112_runs_padded_to_128(causal, window):
    """kimi-k2's head dim, 112, which the kernel has no instance of: q, k
    and v padded with zero columns to 128 (``pad_head_dim``, as the
    launch pads them), the plain version run on them at the unpadded
    scale and the output sliced back give the plain version's result on
    the unpadded inputs; the padded columns of the output are zero."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 8, 24, 112))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 24, 112))
                             .astype(np.float32)) for _ in range(2))
    scale = 112 ** -0.5
    qp, kp, vp = FA.pad_head_dim(q, k, v)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == 128
    assert torch.equal(qp[..., :112], q) and not qp[..., 112:].any()
    out = attention_ref(qp, kp, vp, causal=causal, window=window,
                        scale=scale)
    want = attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    assert not out[..., 112:].any()
    assert float((out[..., :112] - want).abs().max()) < 1e-6
    assert FA.pad_head_dim(q[..., :64])[0].shape[-1] == 64


@pytest.mark.parametrize("d", [64, 128])
def test_p_needs_more_than_bf16(d):
    """Why the bf16 kernel splits P into bf16 hi + lo for O += P·V.

    The kernel's tensor cores take P as bf16.  Emulated here in plain
    torch (float32 scores and P, the row sum from the float32 P, the
    product summed in float32, the output rounded to bf16 once), P
    rounded to bf16 once falls far outside the per-element rule that
    ``chip_smoke.py`` holds the kernel to, |k - p| <= 2^-7·|p| + 2^-12
    against ``attention_ref`` (one bf16 ulp of the plain value): rows
    that see few keys and nearly cancel amplify P's 2^-9 relative error.
    P = P_hi + P_lo, both bf16 and both multiplied, meets it."""
    rng = np.random.default_rng(0)
    s = 512
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, s, d))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    scale = d ** -0.5
    want = attention_ref(q, k, v, causal=True, scale=scale).float()
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                        float("-inf"))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    rowsum = p.sum(-1, keepdim=True)
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()

    def pv(w):
        return torch.einsum("bhqk,bhkd->bhqd", w, v.float())

    allowed = 2.0 ** -7 * want.abs() + 2.0 ** -12

    def share(out):
        return float(((out.bfloat16().float() - want).abs() / allowed).max())

    once, split = share(pv(p_hi) / rowsum), share((pv(p_hi) + pv(p_lo))
                                                  / rowsum)
    assert split <= 1, f"hi + lo at {split:.3g} of the rule"
    # measured 4.5x (D 64) and 4.6x (D 128) the rule
    assert once > 2, f"P rounded once reads only {once:.3g} of the rule"


def test_bf16_operands_need_16_byte_pieces():
    """The bf16 kernel copies rows in 16-byte pieces: a start off a
    16-byte boundary or a row stride that is not a whole number of
    8-element pieces is refused (nothing is copied to make it fit); the
    model's [B, S, H, D] views pass."""
    from repro_torch.kernels import build
    x = torch.zeros((2, 16, 3, 64), dtype=torch.bfloat16)
    build.check_aligned("q", x.transpose(1, 2), 8)
    build.check_aligned("q", x[:, :, :1].transpose(1, 2), 8)
    flat = torch.zeros(2 * 16 * 3 * 64 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        build.check_aligned("q", flat[1:1 + x.numel()].view(x.shape)
                            .transpose(1, 2), 8)
    with pytest.raises(ValueError, match="multiples of 8"):
        build.check_aligned("k", torch.zeros((2, 4, 16, 68),
                                             dtype=torch.bfloat16)
                            [..., :64], 8)


def _attn_params(cfg, seed):
    p = JA.init_attention(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return p, params_module(**{k: _tensor(np.asarray(v))
                               for k, v in p.items()})


@pytest.mark.parametrize("arch,window,s,cap", [
    ("smollm-360m", None, 24, 32),       # full cache, GQA
    ("gemma-2b", None, 24, 24),          # MQA, cache exactly full
    ("smollm-360m", 8, 24, 32),          # SWA ring buffer (s > window)
    ("smollm-360m", 32, 24, 32),         # SWA, prompt inside the window
    ("mixtral-8x7b", 16, 24, 32),        # mixtral's heads, SWA ring buffer
])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_layer_and_cache_match_jax(arch, window, s, cap, impl):
    """Prefill attention output (1e-5: f32, short sums) and the cache it
    builds — k/v rows and pos_map, ring-buffer order included — against
    the JAX layer on both of its compute paths."""
    jcfg = j_reduced(j_get_config(arch), window=window)
    cfg = reduced(get_config(arch), window=window)
    jp, tp = _attn_params(jcfg, 5)
    x = np.random.default_rng(9).standard_normal((2, s, cfg.d_model)) \
        .astype(np.float32)
    jo, jc = JA.attention(jp, jnp.asarray(x), jcfg, impl=impl,
                          make_cache=True, cache_cap=cap)
    to, tc = TA.attention(tp, torch.from_numpy(x), cfg, make_cache=True,
                          cache_cap=cap)
    assert np.abs(to.detach().numpy() - np.asarray(jo)).max() < 1e-5
    assert np.array_equal(tc.pos_map.numpy(), np.asarray(jc.pos_map))
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        assert np.abs(a.detach().numpy() - np.asarray(b)).max() < 1e-5


@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_matches_jax(window):
    """One decode step after a prefill: output and the updated cache."""
    jcfg = j_reduced(j_get_config("smollm-360m"), window=window)
    cfg = reduced(get_config("smollm-360m"), window=window)
    jp, tp = _attn_params(jcfg, 6)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    xn = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    _, jc = JA.attention(jp, jnp.asarray(x), jcfg, make_cache=True,
                         cache_cap=24)
    _, tc = TA.attention(tp, torch.from_numpy(x), cfg, make_cache=True,
                         cache_cap=24)
    jo, jc = JA.decode_attention(jp, jnp.asarray(xn), jcfg, jc,
                                 jnp.int32(20))
    with torch.no_grad():
        to, tc = TA.decode_attention(tp, torch.from_numpy(xn), cfg, tc, 20)
    assert np.abs(to.numpy() - np.asarray(jo)).max() < 1e-5
    assert np.array_equal(tc.pos_map.numpy(), np.asarray(jc.pos_map))
    assert np.abs(tc.k.detach().numpy() - np.asarray(jc.k)).max() < 1e-5


@pytest.mark.parametrize("impl", ["xla", "xla_flash"])
@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x7b"])
def test_lm_forward_and_grads_match_jax_impls(arch, impl):
    """tests/test_attention_impls.py::test_xla_flash_matches_xla on the
    port: the reduced model's forward (1e-4) and every gradient of its
    loss (1e-3) against the JAX package's on both of its attention
    paths (the port has no switch; the device decides).  mixtral runs
    its MoE FFN, so the gradients also cross the router and the
    experts."""
    from repro.models import api as japi
    from repro_torch.convert import lm_from_numpy
    from repro_torch.models import api as tapi
    jcfg = j_reduced(j_get_config(arch))
    cfg = reduced(get_config(arch))
    params = japi.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 40)) \
        .astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    want = np.asarray(japi.forward(params, jbatch, jcfg, impl=impl))
    jg = jax.grad(lambda p: japi.loss_fn(p, jbatch, jcfg, impl=impl))(
        params)
    model = lm_from_numpy(jax.tree.map(np.asarray, params), cfg,
                          device="cpu")
    grads = dict(lm_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                               device="cpu").named_parameters())
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)}
    with torch.no_grad():
        got = tapi.forward(model, batch, cfg).numpy()
    assert np.abs(got - want).max() < 1e-4
    names, ps = zip(*model.named_parameters())
    loss = tapi.loss_fn(model, batch, cfg, remat="none")
    for n, g in zip(names, torch.autograd.grad(loss, ps)):
        assert float((g - grads[n].detach()).abs().max()) < 1e-3, n
