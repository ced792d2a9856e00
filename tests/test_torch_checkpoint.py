"""The port's delta checkpoints (``repro_torch.checkpoint``): the
counterparts of ``tests/test_checkpoint.py`` (bit-exact restore at every
logged step, both anchor selections, the three materialization
policies, the history log, the npz round trip), and the port against
``repro.checkpoint``:

* two stores, one per package, fed the same state sequence (a reduced
  model's ``TrainState`` made from numpy, bf16 params and a float32 or
  int8 optimizer state) under each policy, write the same manifest and
  byte-equal npz arrays under ``convert``'s name map, and answer
  ``select_anchor`` alike.  The JAX package keeps one int8 scale for a
  leaf that stacks every group, the port a copy a group; the port's
  store counts those copies once (``ops_since_snap``);
* the port restores a root written by the JAX package at every logged
  step, bit-equal to the JAX restore carried over by ``convert``;
* the same for an encoder-decoder (whisper-small, its encoder and
  decoder layers stacked under ``enc`` / ``dec``) and the name map of a
  vlm (internvl2-1b, with ``patch_proj``), float32 and int8.
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
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.runtime import init_train_state as j_init  # noqa: E402
from repro_torch.checkpoint import (DeltaCheckpointStore, DeltaPolicy,  # noqa: E402,E501
                                    HistoryLog, load_arrays, load_into,
                                    save_pytree, tensor_measures)
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.checkpoint.deltastore import _apply_bits, _bit_delta  # noqa: E402,E501
from repro_torch.config import TrainConfig, reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (arrays_from_reference,  # noqa: E402
                                 arrays_to_reference, train_state_from_numpy)
from repro_torch.runtime import init_train_state  # noqa: E402


def _rand_state(rng, scale=1.0):
    return {
        "w": torch.tensor(rng.standard_normal((8, 8)) * scale,
                          dtype=torch.float32),
        "emb": torch.tensor(rng.standard_normal((16, 4)) * scale,
                            dtype=torch.float32).to(torch.bfloat16),
        "step": int(rng.integers(100)),
    }


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_bit_delta_invertible_all_dtypes():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float16, np.int32, np.int8):
        a = (rng.standard_normal((32,)) * 50).astype(dtype)
        b = (rng.standard_normal((32,)) * 50).astype(dtype)
        d = _bit_delta(b, a)
        assert np.array_equal(_apply_bits(a, d, True), b)
        assert np.array_equal(_apply_bits(b, d, False), a)


def test_restore_every_logged_step(tmp_path):
    rng = np.random.default_rng(1)
    store = DeltaCheckpointStore(str(tmp_path), DeltaPolicy(period=3))
    states = {}
    template = _rand_state(rng)
    for step in range(0, 50, 5):
        s = _rand_state(rng)
        store.save(step, s)
        states[step] = {k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in s.items()}
    for step, want in states.items():
        for method in ("time", "ops"):
            got = store.restore(step, template, method=method)
            for k in want:
                assert _equal(got[k], want[k]), (step, k)


def test_restart_resumes_from_manifest(tmp_path):
    rng = np.random.default_rng(2)
    store = DeltaCheckpointStore(str(tmp_path))
    s0 = _rand_state(rng)
    store.save(0, s0)
    s1 = _rand_state(rng)
    store.save(7, s1)
    # new process: reopen the same directory
    store2 = DeltaCheckpointStore(str(tmp_path))
    assert store2.latest_step() == 7
    got = store2.restore(7, s0)
    assert torch.equal(got["w"], s1["w"]) and got["step"] == s1["step"]


@pytest.mark.parametrize("kind", ["periodic", "opcount", "similarity"])
def test_policies_materialize(tmp_path, kind):
    rng = np.random.default_rng(3)
    pol = DeltaPolicy(kind=kind, period=2, op_budget=10.0, drift=0.001)
    store = DeltaCheckpointStore(str(tmp_path), pol)
    for step in range(6):
        store.save(step, _rand_state(rng))
    assert len(store.manifest["snapshots"]) >= 2, kind


def test_similarity_policy_skips_when_similar(tmp_path):
    rng = np.random.default_rng(4)
    pol = DeltaPolicy(kind="similarity", drift=0.5)
    store = DeltaCheckpointStore(str(tmp_path), pol)
    base = _rand_state(rng)
    store.save(0, base)
    tweaked = dict(base)
    tweaked["w"] = base["w"] + 1e-4  # tiny drift
    store.save(1, tweaked)
    assert len(store.manifest["snapshots"]) == 1  # no new snapshot


def test_storage_delta_smaller_than_snapshots(tmp_path):
    """Deltas of sparse updates are no larger than full snapshots."""
    rng = np.random.default_rng(5)
    store = DeltaCheckpointStore(str(tmp_path), DeltaPolicy(period=1000))
    s = _rand_state(rng)
    store.save(0, s)
    for step in range(1, 5):
        s = dict(s)
        s["w"] = s["w"] + 0.01
        store.save(step, s)
    b = store.storage_bytes()
    assert b["deltas"] > 0 and b["snapshots"] > 0


def test_history_log_queries(tmp_path):
    h = HistoryLog(str(tmp_path / "h.json"))
    for step in range(0, 100, 10):
        h.record(step, {"loss": 10.0 - step / 10.0,
                        "norm/w": step * 1.0})
    assert h.point("loss", 50) == 5.0
    assert h.diff("loss", 20, 80) == 6.0
    assert h.agg("loss", 0, 90, "mean") == pytest.approx(5.5)
    assert h.agg("norm/w", 0, 90, "max") == 90.0
    # reload from disk
    h2 = HistoryLog(str(tmp_path / "h.json"))
    assert h2.point("loss", 50) == 5.0


def test_pytree_io_roundtrip(tmp_path):
    rng = np.random.default_rng(6)
    tree = _rand_state(rng)
    p = str(tmp_path / "x.npz")
    save_pytree(tree, p)
    with np.load(p) as z:            # the reference's npz layout
        assert sorted(z.files) == ["emb::bf16", "step", "w"]
        assert z["emb::bf16"].dtype == np.uint16
        assert z["step"].dtype == np.int32 and z["step"].shape == ()
    back = load_into(_rand_state(rng), p)
    for k in tree:
        assert _equal(back[k], tree[k]), k
    assert load_arrays(p)["emb"].dtype == torch.bfloat16


def test_restore_refuses_a_mismatched_template(tmp_path):
    rng = np.random.default_rng(7)
    store = DeltaCheckpointStore(str(tmp_path))
    store.save(0, _rand_state(rng))
    bad = _rand_state(rng)
    bad["w"] = bad["w"][:4]
    with pytest.raises(ValueError, match="w"):
        store.restore(0, bad)
    with pytest.raises(KeyError, match="missing extra"):
        store.restore(0, dict(_rand_state(rng), extra=torch.zeros(2)))


def test_tensor_measures_are_the_parameter_norms():
    cfg = reduced(get_config("smollm-360m"))
    st = init_train_state(cfg, TrainConfig(param_dtype="float32"),
                          device="cpu")
    m = tensor_measures(st.params)
    named = dict(st.params.named_parameters())
    assert set(m) == {f"norm/{n}" for n in named} | {"norm/__global__"}
    for n, p in named.items():
        assert m[f"norm/{n}"] == pytest.approx(
            float(np.linalg.norm(p.detach().numpy())), rel=1e-5)
    assert m["norm/__global__"] == pytest.approx(
        sum(v * v for k, v in m.items() if k != "norm/__global__") ** 0.5)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _jax_states(arch, opt_dtype, n, seed):
    """``n`` numpy TrainStates of a reduced ``arch``: the JAX package's
    initial state (bf16 params), then each one a perturbation of the
    last — a random tenth of every float leaf moved, every int8 leaf's
    q stepped, the step counters advanced."""
    jcfg = j_reduced(j_get_config(arch))
    st = jax.tree.map(np.asarray, j_init(
        jax.random.PRNGKey(seed), jcfg, JTrainConfig(
            param_dtype="bfloat16", opt_state_dtype=opt_dtype)))
    rng = np.random.default_rng(seed)
    out = [st]
    for _ in range(n - 1):
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
        out.append(jax.tree.map(move, out[-1]))
    return jcfg, out


def _ref_npz(path):
    """A JAX-written npz as the port reads it: names and raw arrays."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


POLICIES = {"periodic": DeltaPolicy(kind="periodic", period=2),
            "opcount": DeltaPolicy(kind="opcount", op_budget=250000.0),
            "similarity": DeltaPolicy(kind="similarity", drift=0.25)}
STEPS = [0, 1, 2, 4, 5, 7, 8, 9]
# an int8 state moves by whole steps of a small scale: its sequence's
# relative drift a step falls from 4.6 to 0.33 (float32's from 0.28 to
# 0.23), so its similarity threshold splits it at 0.6
INT8_DRIFT = 0.6


@pytest.fixture(scope="module")
def sequences():
    return {od: _jax_states("mamba2-130m", od, len(STEPS), 3)
            for od in ("int8", "float32")}


@pytest.mark.parametrize("opt_dtype", ["float32", "int8"])
@pytest.mark.parametrize("kind", list(POLICIES))
def test_stores_write_the_same_root(tmp_path, sequences, kind, opt_dtype):
    jcfg, states = sequences[opt_dtype]
    cfg = reduced(get_config("mamba2-130m"))
    pol = POLICIES[kind]
    if kind == "similarity" and opt_dtype == "int8":
        pol = DeltaPolicy(kind="similarity", drift=INT8_DRIFT)
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore = jckpt.DeltaCheckpointStore(jroot, jckpt.DeltaPolicy(
        kind=pol.kind, period=pol.period, op_budget=pol.op_budget,
        drift=pol.drift))
    store = DeltaCheckpointStore(root, pol)
    for step, st in zip(STEPS, states):
        jstore.save(step, jax.tree.map(jnp.asarray, st))
        store.save(step, train_state_from_numpy(st, cfg, device="cpu"))
    with open(os.path.join(jroot, "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(root, "manifest.json")) as f:
        man = json.load(f)
    assert man == jman
    assert 1 < len(man["snapshots"]) < len(STEPS), man["snapshots"]
    for step in STEPS:
        for method in ("time", "ops"):
            assert store.select_anchor(step, method) == \
                jstore.select_anchor(step, method)
    files = []
    for d in ("", "snapshots", "deltas"):
        names = sorted(f for f in os.listdir(os.path.join(root, d))
                       if f.endswith(".npz"))
        assert names == sorted(f for f in os.listdir(os.path.join(jroot, d))
                               if f.endswith(".npz"))
        files += [os.path.join(d, f) for f in names]
    for f in files:
        want = _ref_npz(os.path.join(jroot, f))
        got = arrays_to_reference(_ref_npz(os.path.join(root, f)))
        assert set(got) == set(want), f
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape and \
                got[k].tobytes() == want[k].tobytes(), (f, k)


@pytest.mark.parametrize("opt_dtype", ["int8", "float32"])
def test_port_restores_a_jax_root(tmp_path, sequences, opt_dtype):
    jcfg, states = sequences[opt_dtype]
    cfg = reduced(get_config("mamba2-130m"))
    jstore = jckpt.DeltaCheckpointStore(str(tmp_path),
                                        jckpt.DeltaPolicy(period=3))
    for step, st in zip(STEPS, states):
        jstore.save(step, jax.tree.map(jnp.asarray, st))
    store = DeltaCheckpointStore(str(tmp_path))
    jtemplate = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, states[0]))
    template = init_train_state(cfg, TrainConfig(
        param_dtype="bfloat16", opt_state_dtype=opt_dtype), device="cpu")
    for step in STEPS:
        for method in ("time", "ops"):
            want = io.raw_arrays(train_state_from_numpy(
                jax.tree.map(np.asarray, jstore.restore(step, jtemplate,
                                                        method)),
                cfg, device="cpu"))
            got = io.raw_arrays(store.restore(step, template, method))
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and \
                    got[k].tobytes() == want[k].tobytes(), (step, k)


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m",
                                  "mixtral-8x7b", "whisper-small",
                                  "internvl2-1b"])
def test_name_map_both_ways(arch, opt_dtype):
    """``arrays_from_reference`` turns the JAX package's npz entries of
    a TrainState into the port's, and ``arrays_to_reference`` back, bit
    for bit; a stacked int8 leaf's one scale goes to every group (an
    encoder-decoder: to every encoder layer, and every decoder layer)."""
    jcfg = j_reduced(j_get_config(arch))
    js = j_init(jax.random.PRNGKey(1), jcfg, JTrainConfig(
        param_dtype="bfloat16", opt_state_dtype=opt_dtype))
    ref = {}
    for k, leaf in _paths_and_leaves(js):
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            ref[k + "::bf16"] = a.view(np.uint16)
        else:
            ref[k] = a
    port = io.raw_arrays(train_state_from_numpy(
        jax.tree.map(np.asarray, js), reduced(get_config(arch)),
        device="cpu"))
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
    if arch == "internvl2-1b":
        assert "params/patch_proj::bf16" in port
    stacks = ({"enc": jcfg.n_enc_layers, "dec": jcfg.n_layers}
              if jcfg.family == "encdec" else {"groups": jcfg.n_layers})
    if opt_dtype == "int8":
        for stack, n in stacks.items():
            scales = [port[k] for k in port
                      if k.startswith(f"opt/m/{stack}.") and k.endswith(
                          "l0.ssm.in_proj/scale" if arch.startswith("mamba")
                          else ".attn.wq/scale")]
            assert len(scales) == n and \
                all(s.tobytes() == scales[0].tobytes() for s in scales)
        # groups with scales of their own have no JAX counterpart
        port = dict(port)
        k = next(k for k in port
                 if k.startswith(f"opt/m/{list(stacks)[-1]}.1.")
                 and k.endswith("/scale"))
        port[k] = port[k] * 2
        with pytest.raises(ValueError, match="scales differ"):
            arrays_to_reference(port)


def test_moe_param_tree_carries_across_both_ways():
    """A MoE LM's param tree (mixtral, two groups): ``lm_from_numpy``
    carries every leaf across — ``groups.<g>.l0.moe.{wg, w_up, w_gate,
    w_down}`` unstacked by group and stacked over experts, the router
    float32, the experts bf16 through the int16 view — and
    ``arrays_to_reference`` takes the port's arrays back to the JAX
    package's tree paths bit for bit."""
    from repro.models import api as japi
    from repro_torch.convert import lm_from_numpy
    jcfg = j_reduced(j_get_config("mixtral-8x7b"))
    cfg = reduced(get_config("mixtral-8x7b"))
    params = japi.init_params(jax.random.PRNGKey(4), jcfg, jnp.bfloat16)
    model = lm_from_numpy(jax.tree.map(np.asarray, params), cfg,
                          device="cpu")
    own = dict(model.named_parameters())
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    for g in range(cfg.n_layers):
        pre = f"groups.{g}.l0.moe."
        assert own[pre + "wg"].dtype == torch.float32
        assert tuple(own[pre + "wg"].shape) == (d, e)
        for name, shape in (("w_up", (e, d, f)), ("w_gate", (e, d, f)),
                            ("w_down", (e, f, d))):
            assert own[pre + name].dtype == torch.bfloat16
            assert tuple(own[pre + name].shape) == shape
    # a TrainState's params as the JAX package names them in an npz
    ref = {}
    for k, leaf in _paths_and_leaves(params):
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            ref[".params/" + k + "::bf16"] = a.view(np.uint16)
        else:
            ref[".params/" + k] = a
    assert ".params/groups/l0/moe/wg" in ref
    back = arrays_to_reference(io.raw_arrays({"params": model}))
    assert set(back) == set(ref)
    for k in ref:
        assert back[k].dtype == ref[k].dtype and \
            back[k].tobytes() == ref[k].tobytes(), k


@pytest.fixture(scope="module")
def encdec_sequences():
    return {od: _jax_states("whisper-small", od, len(STEPS), 5)
            for od in ("int8", "float32")}


@pytest.mark.parametrize("opt_dtype", ["int8", "float32"])
def test_port_restores_a_jax_encdec_root(tmp_path, encdec_sequences,
                                         opt_dtype):
    """A root the JAX package writes for reduced whisper-small (layers
    stacked under ``enc`` and ``dec``): the port restores every logged
    step bit-equal to the JAX restore carried over, and a port store fed
    the same states writes the same manifest (the repeated int8 scales of
    ``enc`` / ``dec`` counted once, ``io.stacked_copy``) and byte-equal
    arrays under the name map."""
    jcfg, states = encdec_sequences[opt_dtype]
    cfg = reduced(get_config("whisper-small"))
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore = jckpt.DeltaCheckpointStore(jroot, jckpt.DeltaPolicy(
        kind="opcount", op_budget=250000.0))
    store = DeltaCheckpointStore(root, DeltaPolicy(kind="opcount",
                                                   op_budget=250000.0))
    for step, st in zip(STEPS, states):
        jstore.save(step, jax.tree.map(jnp.asarray, st))
        store.save(step, train_state_from_numpy(st, cfg, device="cpu"))
    with open(os.path.join(jroot, "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(root, "manifest.json")) as f:
        assert json.load(f) == jman
    assert 1 < len(jman["snapshots"]) < len(STEPS), jman["snapshots"]
    for d in ("snapshots", "deltas"):
        for name in os.listdir(os.path.join(jroot, d)):
            want = _ref_npz(os.path.join(jroot, d, name))
            got = arrays_to_reference(_ref_npz(os.path.join(root, d, name)))
            assert set(got) == set(want), name
            for k in want:
                assert got[k].tobytes() == want[k].tobytes(), (name, k)

    restorer = DeltaCheckpointStore(jroot)
    jtemplate = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, states[0]))
    template = init_train_state(cfg, TrainConfig(
        param_dtype="bfloat16", opt_state_dtype=opt_dtype), device="cpu")
    for step in STEPS:
        want = io.raw_arrays(train_state_from_numpy(
            jax.tree.map(np.asarray, jstore.restore(step, jtemplate)), cfg,
            device="cpu"))
        got = io.raw_arrays(restorer.restore(step, template))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].tobytes() == want[k].tobytes(), (step, k)


def test_stacked_copy_names_every_stacked_prefix():
    """A later slice's int8 scale of a stacked leaf repeats the first
    slice's, under every prefix the JAX package stacks."""
    for stack in ("groups", "enc", "dec"):
        assert not io.stacked_copy(f"opt/m/{stack}.0.attn.wq/scale")
        assert io.stacked_copy(f"opt/v/{stack}.1.attn.wq/scale")
        assert not io.stacked_copy(f"opt/m/{stack}.1.attn.wq/q")
    for key in ("opt/m/enc_norm.scale/scale", "opt/m/patch_proj/scale",
                "params/enc.1.attn.wq"):
        assert not io.stacked_copy(key)
