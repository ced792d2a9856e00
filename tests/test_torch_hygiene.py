"""Rules of the port that a reader cannot see from parity alone:

* no file of ``src/repro_torch/`` — nor ``chip_smoke.py`` — imports
  ``jax`` or anything of ``repro``;
* the default ``device`` is the card, and without one it raises instead
  of quietly running on the CPU;
* a kernel wrapper has no ``try`` around its launch (no fallback), and
  each CUDA source names the Pallas kernel it replaces;
* building the kernels happens at first use, never at import.
"""
import ast
import os
import re

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files(ext=".py"):
    out = []
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(ext)]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


@pytest.mark.parametrize("path", _port_files() + [
    os.path.join(ROOT, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_port_has_every_module_of_the_slice():
    want = ["obs/clock.py", "obs/trace.py", "obs/metrics.py",
            "obs/slowlog.py", "core/delta.py", "core/graph.py",
            "core/reconstruct.py", "core/queries.py", "core/index.py",
            "core/partial.py", "core/plans.py", "core/materialize.py",
            "core/segments.py", "core/store.py", "core/generate.py",
            "core/engine.py", "serving/policy.py", "serving/ingest.py",
            "serving/frontend.py", "api.py", "convert.py",
            "persist/__init__.py", "persist/manifest.py", "persist/wal.py",
            "persist/recovery.py", "replica/__init__.py",
            "replica/faults.py", "replica/shipping.py", "replica/replica.py",
            "replica/router.py", "sharding/__init__.py",
            "sharding/graph.py", "core/distributed.py",
            "kernels/delta_apply/delta_apply.cu",
            "kernels/edge_delta_apply/edge_delta_apply.cu",
            "kernels/degree_series/degree_series.cu",
            "kernels/evolve_sweep/sweep.cu",
            "config.py", "configs/__init__.py", "configs/smollm_360m.py",
            "configs/mamba2_130m.py", "models/layers.py",
            "models/attention.py", "models/ssm.py", "models/blocks.py",
            "models/lm.py", "models/api.py", "models/moe.py",
            "models/encdec.py", "configs/whisper_small.py",
            "configs/internvl2_1b.py",
            "kernels/flash_attention/ref.py",
            "kernels/flash_attention/ops.py",
            "kernels/flash_attention/flash_attention.cu",
            "kernels/ssd_scan/ref.py", "kernels/ssd_scan/ops.py",
            "kernels/ssd_scan/ssd_scan.cu",
            "optim/__init__.py", "optim/adamw.py", "optim/schedule.py",
            "optim/compress.py",
            "data/__init__.py", "data/synthetic.py",
            "runtime/__init__.py", "runtime/steps.py",
            "runtime/failures.py", "runtime/stragglers.py",
            "runtime/elastic.py", "launch/mesh.py", "launch/dryrun.py",
            "checkpoint/__init__.py", "checkpoint/io.py",
            "checkpoint/deltastore.py", "checkpoint/history.py",
            "launch/__init__.py", "launch/train.py", "launch/serve.py",
            "analysis/__init__.py", "analysis/__main__.py",
            "analysis/base.py", "analysis/driver.py",
            "analysis/registry.py", "analysis/lockdep.py",
            "analysis/passes/__init__.py",
            "analysis/passes/clock_discipline.py",
            "analysis/passes/epoch_immutability.py",
            "analysis/passes/lock_discipline.py",
            "analysis/passes/wal_ordering.py",
            "analysis/passes/torch_hotpath.py"]
    missing = [w for w in want if not os.path.exists(os.path.join(PORT, w))]
    assert not missing


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from repro_torch import resolve_device
    from repro_torch.api import GraphSession
    from repro_torch.core.store import TemporalGraphStore
    from repro_torch.persist import open_store
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSession(n_cap=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TemporalGraphStore(8)
    # a durable root: neither created nor recovered off the card
    root = str(tmp_path / "g")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSession(path=root, n_cap=8)
    open_store(root, n_cap=8, device="cpu").store.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        open_store(root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSession.open(root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        open_store(root, readonly=True)
    # a replica: neither opened over a transport nor restarted from its
    # mirror off the card
    from repro_torch.replica import LocalDirTransport, ReadReplica
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSession.open_replica(root, str(tmp_path / "rep"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReadReplica(LocalDirTransport(root), str(tmp_path / "rep"))
    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.models import api as lm_api
    cfg = reduced(get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_api.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_api.init_decode_caches(cfg, 1, 8)
    for arch in ("whisper-small", "internvl2-1b"):
        fam = reduced(get_config(arch))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm_api.init_params(fam, torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm_api.init_decode_caches(fam, 1, 8)
    # training: the trainer, its command line, its state and its data
    from repro_torch.config import ShardingConfig, TrainConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import main, train
    from repro_torch.runtime import init_train_state
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, TrainConfig(total_steps=1), ShardingConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "mamba2-130m", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(cfg, 1, 8)
    # the serving driver and the graph built from host arrays
    from repro_torch.core import dense_from_numpy
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--nodes", "8", "--queries", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dense_from_numpy([True, True], [(0, 1)])
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("name", ["delta_apply", "edge_delta_apply",
                                  "degree_series", "evolve_sweep",
                                  "flash_attention", "ssd_scan"])
def test_wrappers_have_no_fallback(name):
    """A CUDA tensor launches the kernel or raises: no ``try`` in the
    wrapper module, and the CPU branch is taken only on a CPU device."""
    src = "sweep.py" if name == "evolve_sweep" else "ops.py"
    path = os.path.join(PORT, "kernels", name, src)
    tree = ast.parse(open(path).read())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    text = open(path).read()
    assert 'device.type == "cpu"' in text
    assert re.search(r'LAUNCHES\["\w+"\] \+= 1', text)


@pytest.mark.parametrize("path", _port_files(".cu"),
                         ids=os.path.basename)
def test_cuda_sources_name_what_they_replace(path):
    text = open(path).read()
    m = re.search(r"Replaces: (src/)?repro/kernels/(\S+)::\s*(\w+)",
                  text.replace("\n// ", " "))
    assert m, path
    assert os.path.exists(os.path.join(ROOT, "src", "repro", "kernels",
                                       m.group(2)))
    assert "bounds it on the H100" in text


def test_kernels_are_not_built_at_import():
    from repro_torch.kernels import build
    assert build.ext.cache_info().currsize == 0 or \
        torch.cuda.is_available()


def test_wrapper_operand_checks():
    """The checks every wrapper runs before a launch refuse what the
    kernel does not take (device, dtype, rank, contiguity, mixed
    devices)."""
    from repro_torch.kernels import build
    x = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        build.check_cuda("x", x, torch.int32, 2)
    meta = torch.empty((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        build.check_cuda("x", meta, torch.int32, 2)
    with pytest.raises(ValueError, match="different devices"):
        build.check_same_device(a=x, b=meta)
    build.check_same_device(a=x, b=x.t())
