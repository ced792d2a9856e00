"""The port's SSD scan (plain versions, the kernel wrapper's CPU path)
and its Mamba2 block against ``repro.kernels.ssd_scan`` and
``repro.models.ssm``.

Inputs come from numpy with fixed seeds and go through both packages.
The JAX side runs the Pallas kernel in interpret mode, the per-step
oracle ``ssd_ref`` and the model's ``ssd_chunked``.  ``y`` is held to
the JAX tests' 5e-5 (``tests/test_kernels.py::TestSSDScan``: float32
sums over a chunk in another order); the final state, which the TPU
kernel does not return, to the same bound against JAX ``ssd_chunked``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.ssd_scan import ssd_ref as j_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import _tensor  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.layers import params_module  # noqa: E402

TOL = 5e-5


def _inputs(b, s, h, p, n, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


def _pad(arrs, chunk):
    """Pad the sequence to a chunk multiple with inert (dt = 0) steps, as
    ``apply_ssm`` does before the scan."""
    x, dt, a, B, C = arrs
    pad = (-x.shape[1]) % chunk

    def p(t):
        return np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
    return p(x), p(dt), a, p(B), p(C)


def _diff(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("b,s,h,p,n,chunk",
                         [(2, 64, 3, 8, 16, 16), (1, 100, 2, 16, 8, 32),
                          (2, 128, 4, 32, 64, 128), (1, 48, 1, 64, 128, 16)])
def test_scan_matches_jax_kernel_ref_and_state(b, s, h, p, n, chunk):
    arrs = _inputs(b, s, h, p, n)
    want_kernel = j_ssd_scan(*map(jnp.asarray, arrs), chunk=chunk)
    want_ref = j_ssd_ref(*map(jnp.asarray, arrs))
    padded = _pad(arrs, chunk)
    _, want_h = JS.ssd_chunked(*map(jnp.asarray, padded), chunk)
    y, hT = ssd_scan(*map(torch.from_numpy, padded), chunk)
    assert tuple(hT.shape) == (b, h, p, n)
    assert _diff(y[:, :s], want_kernel) < TOL
    assert _diff(y[:, :s], want_ref) < TOL
    assert _diff(hT, want_h) < TOL


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_chunked_and_sequential_match_jax_with_initial_state(chunk):
    arrs = _inputs(2, 64, 3, 8, 16, seed=3)
    s0 = 0.1 * np.random.default_rng(4).standard_normal(
        (2, 3, 8, 16)).astype(np.float32)
    jy, jh = JS.ssd_sequential(*map(jnp.asarray, arrs), jnp.asarray(s0))
    ty, th = TS.ssd_sequential(*map(torch.from_numpy, arrs),
                               torch.from_numpy(s0))
    assert _diff(ty, jy) < 1e-5 and _diff(th, jh) < 1e-5
    cy, ch = TS.ssd_chunked(*map(torch.from_numpy, arrs), chunk,
                            torch.from_numpy(s0))
    assert _diff(cy, jy) < 1e-4 and _diff(ch, jh) < 1e-4   # test_ssm.py's


def test_state_carries_across_calls():
    """Two halves with the state carried equal one pass (the prefill →
    decode contract the kernel's final-state output serves)."""
    x, dt, a, B, C = map(torch.from_numpy, _inputs(2, 64, 3, 8, 16, 5))
    yf, hf = ssd_scan(x, dt, a, B, C, 16)
    ya, ha = ssd_scan(x[:, :32], dt[:, :32], a, B[:, :32], C[:, :32], 16)
    yb, hb = ssd_scan(x[:, 32:], dt[:, 32:], a, B[:, 32:], C[:, 32:], 16,
                      ha)
    assert _diff(torch.cat([ya, yb], 1), yf.numpy()) < 1e-5
    assert _diff(hb, hf.numpy()) < 1e-5


def _ssm_params(cfg, seed):
    p = JS.init_ssm(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return p, params_module(**{k: _tensor(np.asarray(v))
                               for k, v in p.items()})


@pytest.mark.parametrize("s", [16, 20, 37])
def test_apply_and_decode_match_jax(s):
    """The Mamba2 block on the chunk-padding path (s not a multiple of
    the chunk) and the chunk == s path, then one decode step: outputs
    and both caches (1e-5: float32, short sums)."""
    jcfg = j_reduced(j_get_config("mamba2-130m"))
    cfg = reduced(get_config("mamba2-130m"))
    jp, tp = _ssm_params(jcfg, 2)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    xn = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jo, jc = JS.apply_ssm(jp, jnp.asarray(x), jcfg, return_cache=True)
    with torch.no_grad():
        to, tc = TS.apply_ssm(tp, torch.from_numpy(x), cfg,
                              return_cache=True)
    assert _diff(to, jo) < 1e-5
    assert _diff(tc.conv, jc.conv) < 1e-5
    assert _diff(tc.state, jc.state) < 1e-5
    jo, jc = JS.decode_ssm(jp, jnp.asarray(xn), jcfg, jc)
    with torch.no_grad():
        to, tc = TS.decode_ssm(tp, torch.from_numpy(xn), cfg, tc)
    assert _diff(to, jo) < 1e-5
    assert _diff(tc.state, jc.state) < 1e-5


def test_causal_conv_bfloat16():
    """The taps are summed in bfloat16, left to right, as in the JAX
    package: the carried conv state is the input itself (bit-exact) and
    the output differs only by silu's rounding (<= 2 bfloat16 ulps)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 40, 24)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, 24)), jnp.bfloat16)
    jo, jprev = JS._causal_conv(x, w)
    to, tprev = TS._causal_conv(_tensor(np.asarray(x)),
                                _tensor(np.asarray(w)))
    assert to.dtype == torch.bfloat16
    assert np.array_equal(tprev.view(torch.int16).numpy(),
                          np.asarray(jprev).view(np.int16))
    a = np.asarray(jo.astype(jnp.float32))
    b = to.float().numpy()
    assert (np.abs(a - b) <= 2 * 2.0 ** -7 * np.abs(a) + 1e-30).all()


def test_scan_launch_refuses_tensors_off_the_card():
    meta = [torch.empty(s, device="meta")
            for s in ((1, 16, 2, 8), (1, 16, 2), (2,), (1, 16, 4),
                      (1, 16, 4))]
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_scan(*meta, 16)


def test_segment_sums_lose_digits_in_float32():
    """Why ``ssd_scan.cu`` keeps the in-chunk cumsum of a·dt in float64.

    At the mamba2-130m prefill's a (down to -16) and dt (softplus of
    N(0, 1)), cum reaches ~-10^3 within a chunk of 256 steps, and the
    decay exp(cum_i - cum_j) formed from float32 cums keeps only the
    digits their difference has left: its relative error grows with
    |cum|.  Formed from float64 cums (the difference rounded to float32
    once) the error is that of the segment alone.  The float32 scan's
    error is dominated by this (on the card the kernel, with float64
    cums, reads 30-60x closer to a float64 scan than the float32 plain
    version)."""
    rng = np.random.default_rng(0)
    q, h = 256, 24
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((q, h)).astype(np.float32)))
    a = -torch.linspace(1.0, 16.0, h)
    cum32 = torch.cumsum(dt * a, 0)
    cum64 = torch.cumsum(dt.double() * a.double(), 0)
    i, j = torch.tril_indices(q, q)
    seg64 = cum64[i] - cum64[j]
    keep = seg64 > -80.0                  # decays float32 still holds
    truth = torch.exp(seg64[keep])
    from32 = torch.exp(cum32[i] - cum32[j])[keep].double()
    from64 = torch.exp(seg64[keep].float()).double()
    err32 = float(((from32 - truth).abs() / truth).max())
    err64 = float(((from64 - truth).abs() / truth).max())
    assert float(cum64.min()) < -1000
    assert err64 < 1e-5 and err32 > 10 * err64, (err32, err64)
