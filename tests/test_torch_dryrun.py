"""The port's dry-run (``repro_torch.launch.dryrun``) and
``models.api.input_specs``, against the reference's
``launch/dryrun.py`` and ``tests/test_distributed.py::
test_dryrun_machinery_small_mesh`` (whose own run fails here, ROADMAP
C3):

* in process, ``input_specs`` of every architecture × shape equal to
  the reference's ``ShapeDtypeStruct``s, leaf for leaf, by shape and
  dtype, and never allocated (meta tensors);
* two subprocesses at once, one a fake device (this file run as a
  script, importing only ``repro_torch``; the dry-run's fake process
  group owns each, hazard (aa)), that trace:

  - the reference test's checks — flops > 0, some all-reduce,
    all-gather or reduce-scatter — for a reduced model of each of the
    six families, one layer (the hybrid one period of 2: an SSM layer,
    then attention with a MoE), 8 × 16 tokens: a train, a prefill and a
    decode cell on a (4, 2) mesh, on the ``"cpu"`` and ``"cuda"`` fake
    devices, under the baseline rules and under the ruleset the
    architecture's ``DEFAULT_RULES`` names (this torch build has no
    CUDA: the subprocess starts with ``dryrun.fake_cuda_env()``, the
    fake CUDA device of ``launch/fake_cuda.cpp`` preloaded);
  - exact, the per-device count: reduced smollm-360m's train cell under
    ``dp_all`` (its batch of 8 over all 8 processes) at 8 × its flops
    equals the world-1 trace's at the same global batch;
  - exact, the card's path counts like the plain path: B5's and B6's
    custom ops (their flop formulas) give the ``"cuda"`` prefill of the
    dense and the ssm family the flops of the ``"cpu"`` one;
  - ``long_500k`` skipped for a full-attention architecture with the
    reference's message, and run for mamba2-130m;
  - a big architecture (kimi-k2) reduced, trained with the int8
    optimizer state and ``fsdp_pod`` on a (pod 2, data 2, model 2) mesh
    under its ``ep_moe`` rules;
  - ``run_cell`` refusing to start where a real (``gloo``) group is up.

Budget: ~60 s, the two processes on one thread each (~100 s of CPU in
all: a cell's first trace pays DTensor's sharding propagation, 1–6 s).
"""
import json
import os
import subprocess
import sys
import time
import traceback

FAMILIES = {"dense": "smollm-360m", "moe": "mixtral-8x7b",
            "ssm": "mamba2-130m", "hybrid": "jamba-1.5-large-398b",
            "encdec": "whisper-small", "vlm": "internvl2-1b"}
KINDS = ("train", "prefill", "decode")
DEVICES = ("cpu", "cuda")
BATCH, SEQ = 8, 16
MESH = (4, 2)
LONG_SKIP = ("full-attention arch; long_500k needs sub-quadratic "
             "attention (DESIGN.md §5)")
TIMEOUT_S = 300


def machinery_config(family: str, reduced, get_config):
    """The family's reduced config at one layer (the hybrid: one period
    of 2 — an SSM layer, then attention with the MoE)."""
    arch = FAMILIES[family]
    if family == "hybrid":
        return reduced(get_config(arch), n_layers=2, attn_period=2,
                       attn_offset=1)
    return reduced(get_config(arch), n_layers=1)


def _cell(res: dict) -> dict:
    return {k: res[k] for k in ("flops_per_device", "bytes_per_device",
                                "collective", "memory_analysis", "rules",
                                "fsdp_pod", "opt_state_dtype", "n_chips",
                                "mesh", "device", "roofline",
                                "useful_flops_ratio") if k in res}


def probe() -> int:
    """Hazard (x): ``Trace``'s flops of a DTensor product [16, 64] @
    [64, 32] on a (4, 2) fake mesh, rows over ``data`` and columns over
    ``model``: rank 0's local product [4, 64] @ [64, 16] only."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import dryrun
    dryrun.fake_group(8)
    mesh = dryrun._mesh(MESH, "cpu")
    with dryrun._fake_mode():
        a = distribute_tensor(torch.randn(16, 64), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(torch.randn(64, 32), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with dryrun.Trace() as trace:
            torch.mm(a, b)
    return trace.flops


def worker(out: str, device: str) -> int:
    """The machinery cells on ``device``; the ``"cpu"`` process also the
    exact checks and the refusal of a real group."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.config import ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    res: dict = {"machinery": {}, "seconds": {}}
    t0 = time.perf_counter()
    for family, arch in FAMILIES.items():
        cfg = machinery_config(family, reduced, get_config)
        named = dryrun.DEFAULT_RULES.get(arch)
        for rules in ("baseline",) + ((named,) if named else ()):
            for kind in KINDS:
                key = f"{family}/{rules}/{device}/{kind}"
                shape = ShapeConfig("t", SEQ, BATCH, kind)
                t1 = time.perf_counter()
                res["machinery"][key] = _cell(dryrun.run_cell(
                    arch, "t", device=device, cfg=cfg, shape=shape,
                    mesh_shape=MESH, rules_name=rules))
                res["seconds"][key] = time.perf_counter() - t1
    res["seconds"][f"machinery {device}"] = time.perf_counter() - t0
    if device == "cuda":
        return _write(out, device, res)
    res["probe"] = probe()

    t0 = time.perf_counter()
    cfg = machinery_config("dense", reduced, get_config)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    res["per_device"] = {
        world: dryrun.run_cell("smollm-360m", "t", device="cpu", cfg=cfg,
                               shape=shape, mesh_shape=mesh,
                               rules_name="dp_all")["flops_per_device"]
        for world, mesh in (("8", MESH), ("1", (1, 1)))}

    res["long"] = {
        arch: dryrun.run_cell(arch, "long_500k", device="cpu",
                              cfg=reduced(get_config(arch), n_layers=1),
                              shape=ShapeConfig("long_500k", SEQ, 1,
                                                "decode"),
                              mesh_shape=MESH)
        for arch in ("smollm-360m", "mamba2-130m")}
    res["long"] = {a: r.get("skipped") or _cell(r)
                   for a, r in res["long"].items()}

    kimi = reduced(get_config("kimi-k2-1t-a32b"), n_layers=1)
    res["big"] = _cell(dryrun.run_cell(
        "kimi-k2-1t-a32b", "train_4k", device="cpu", cfg=kimi,
        shape=ShapeConfig("train_4k", SEQ, BATCH, "train"),
        mesh_shape=(2, 2, 2)))
    res["seconds"]["exact"] = time.perf_counter() - t0

    import torch.distributed as dist
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous",
                            rank=0, world_size=1)
    try:
        dryrun.run_cell("smollm-360m", "t", device="cpu", cfg=cfg,
                        shape=shape, mesh_shape=(1, 1))
        res["refused_real_group"] = None
    except RuntimeError as exc:
        res["refused_real_group"] = str(exc)
    finally:
        dist.destroy_process_group()
    return _write(out, device, res)


def _write(out: str, device: str, res: dict) -> int:
    with open(os.path.join(out, f"results_{device}.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    try:
        sys.exit(worker(sys.argv[2], sys.argv[3]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.config import SHAPES  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import api  # noqa: E402

jax.devices()


@pytest.mark.parametrize("shape", sorted(J_SHAPES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_input_specs_match_reference(arch, shape):
    """Every leaf of the reference's ``input_specs``, by shape and
    dtype (int32 tokens, labels and decode token / pos; bfloat16 frames
    and patches), as meta tensors."""
    assert set(ARCHS) == set(J_ARCHS) and set(SHAPES) == set(J_SHAPES)
    want = japi.input_specs(j_get_config(arch), J_SHAPES[shape])
    got = api.input_specs(get_config(arch), SHAPES[shape])
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), (k, got[k].shape)
        assert str(got[k].dtype).split(".")[-1] == np.dtype(w.dtype).name \
            or (w.dtype == jax.numpy.bfloat16
                and got[k].dtype == torch.bfloat16), (k, got[k].dtype)
        assert got[k].device.type == "meta"


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    env = dryrun.fake_cuda_env(dict(os.environ, OMP_NUM_THREADS="1"))
    t0 = time.monotonic()
    procs = {device: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", out, device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for device in DEVICES}
    res: dict = {"machinery": {}, "seconds": {}}
    try:
        for device, proc in procs.items():
            log = proc.communicate(timeout=max(
                TIMEOUT_S - (time.monotonic() - t0), 1))[0].decode(
                    errors="replace")
            path = os.path.join(out, f"results_{device}.json")
            assert proc.returncode == 0 and os.path.exists(path), log[-4000:]
            with open(path) as f:
                part = json.load(f)
            for k in ("machinery", "seconds"):
                res[k].update(part.pop(k))
            res.update(part)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    res["wall_s"] = time.monotonic() - t0
    return res


def _machinery_keys():
    keys = []
    for family, arch in FAMILIES.items():
        named = dryrun.DEFAULT_RULES.get(arch)
        for rules in ("baseline",) + ((named,) if named else ()):
            for device in DEVICES:
                for kind in KINDS:
                    keys.append(f"{family}/{rules}/{device}/{kind}")
    return keys


@pytest.mark.parametrize("key", _machinery_keys())
def test_dryrun_machinery_small_mesh(traced, key):
    """The reference test's checks on each cell: flops > 0 and some
    all-reduce, all-gather or reduce-scatter (and an argument size and a
    peak, the peak at least the arguments)."""
    r = traced["machinery"][key]
    family, rules, device, kind = key.split("/")
    assert r["flops_per_device"] > 0, key
    counts = r["collective"]["counts"]
    assert counts["all-reduce"] + counts["all-gather"] + \
        counts["reduce-scatter"] > 0, (key, counts)
    assert r["collective"]["total"] > 0
    mem = r["memory_analysis"]
    assert 0 < mem["argument_size_in_bytes"] <= mem["peak_bytes"], mem
    assert r["n_chips"] == 8 and r["mesh"] == "4x2" and r["device"] == device
    assert r["rules"] == rules


def test_flops_are_per_device(traced):
    """Exact: reduced smollm-360m's train step under ``dp_all`` (its
    batch of 8 split over all 8 processes, ZeRO-3 over them) counts 1/8
    of the world-1 trace's flops at the same global batch."""
    per = traced["per_device"]
    assert per["1"] > 0
    assert per["8"] * 8 == per["1"]


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_the_cards_path_counts_like_the_plain_path(traced, family):
    """Exact: the ``"cuda"`` prefill (B5 / B6 through their custom ops'
    flop formulas) counts the ``"cpu"`` prefill's flops (the plain
    versions' products), under the baseline rules and the named ones."""
    named = dryrun.DEFAULT_RULES.get(FAMILIES[family])
    for rules in ("baseline",) + ((named,) if named else ()):
        cpu = traced["machinery"][f"{family}/{rules}/cpu/prefill"]
        cuda = traced["machinery"][f"{family}/{rules}/cuda/prefill"]
        assert cuda["flops_per_device"] == cpu["flops_per_device"] > 0


def test_a_dtensor_product_is_counted_once_locally(traced):
    """Hazard (x): the DTensor op is handed on and its local op counted:
    2 · 4 · 64 · 16 flops, 1/8 of the global 2 · 16 · 64 · 32 (a
    ``FlopCounterMode`` around it counts both, 73,728)."""
    assert traced["probe"] == 2 * 4 * 64 * 16 == 2 * 16 * 64 * 32 // 8


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_the_cards_train_step_adds_the_kernels_recompute(traced, family):
    """The card's train step: the plain step's flops and, once more, the
    forward of each B5 / B6 call, which the kernel's backward recomputes
    through the plain version (no backward kernel): the ``"cuda"`` train
    cell counts more than the ``"cpu"`` one, by at most the forward's
    share."""
    cpu = traced["machinery"][f"{family}/baseline/cpu/train"]
    cuda = traced["machinery"][f"{family}/baseline/cuda/train"]
    extra = cuda["flops_per_device"] - cpu["flops_per_device"]
    prefill = traced["machinery"][f"{family}/baseline/cpu/prefill"]
    assert 0 < extra < prefill["flops_per_device"]


def test_long_500k_skips_full_attention(traced):
    assert traced["long"]["smollm-360m"] == LONG_SKIP
    r = traced["long"]["mamba2-130m"]
    assert isinstance(r, dict) and r["flops_per_device"] > 0


def test_big_arch_trains_int8_with_fsdp_pod_on_a_pod_mesh(traced):
    """kimi-k2 (reduced) on (pod 2, data 2, model 2): the reference's
    rule for the big architectures — the int8 optimizer state, fsdp over
    (pod, data) — under ``ep_moe``."""
    r = traced["big"]
    assert r["opt_state_dtype"] == "int8" and r["fsdp_pod"]
    assert r["rules"] == "ep_moe" and r["mesh"] == "2x2x2"
    assert r["n_chips"] == 8 and r["flops_per_device"] > 0
    assert r["collective"]["counts"]["all-reduce"] > 0


def test_run_cell_refuses_a_real_group(traced):
    msg = traced["refused_real_group"]
    assert msg is not None and "a real one (gloo) is up" in msg


def test_collective_kinds_of_both_styles():
    """Hazard (y): the kinds of DTensor's functional collectives and of
    c10d's in-place ones (``dist.all_reduce``) map to the reference's."""
    ops = torch.ops
    assert dryrun.collective_kind(
        ops._c10d_functional.all_reduce.default) == "all-reduce"
    assert dryrun.collective_kind(ops.c10d.allreduce_.default) == "all-reduce"
    assert dryrun.collective_kind(
        ops._c10d_functional.all_gather_into_tensor.default) == "all-gather"
    assert dryrun.collective_kind(
        ops._c10d_functional.reduce_scatter_tensor.default) == \
        "reduce-scatter"
    assert dryrun.collective_kind(
        ops._c10d_functional.all_to_all_single.default) == "all-to-all"
    assert dryrun.collective_kind(
        ops._c10d_functional.wait_tensor.default) is None
    assert dryrun.collective_kind(ops.aten.mm.default) is None
