"""The port's graphlint (``repro_torch.analysis``) — the counterparts of
``tests/test_analysis.py``: static passes, suppressions, the CLI
(``python -m repro_torch.analysis``), and the runtime lock-order
sanitizer.

The four passes copied from ``repro.analysis`` (lock-discipline,
wal-ordering, epoch-immutability, clock-discipline) get each (bad,
clean) fixture pair once per package, under that package's own path
(``repro/obs/reg.py``, ``repro_torch/obs/reg.py``): both must report the
same rules.  The host-sync pass is the port's own (``torch_hotpath``):
its fixtures are torch idioms — ``x.sum().item()`` in ``kernels/``
flagged, its suppressed twin clean — in every module it scopes.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

import repro.analysis as ref_analysis
from repro.analysis.base import parse_source as ref_parse_source
from repro_torch.analysis import analyze_files, analyze_paths, lockdep
from repro_torch.analysis.base import parse_source
from repro_torch.analysis.registry import create_passes, rule_catalog

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PACKAGES = ["repro", "repro_torch"]


def lint(src, relpath, select=None, package="repro_torch"):
    """``src`` analyzed by ``package``'s graphlint as the file
    ``relpath``."""
    if package == "repro":
        pf = ref_parse_source(relpath, textwrap.dedent(src))
        return ref_analysis.analyze_files([pf], select)
    pf = parse_source(relpath, textwrap.dedent(src))
    return analyze_files([pf], select)


def rules_of(report):
    return sorted({f.rule for f in report.findings})


# ------------------------------------------------------------ registry

def test_registry_catalog_lists_all_passes():
    rows = rule_catalog()
    passes = {r[0] for r in rows}
    rules = {r[1] for r in rows}
    assert passes == {"lock-discipline", "wal-ordering",
                      "epoch-immutability", "torch-hotpath",
                      "clock-discipline"}
    assert {"lock-order", "unlocked-mutation", "wal-order",
            "epoch-freeze", "host-sync", "jit-unhashable-default",
            "clock"} <= rules
    # the same rule ids as the reference's catalog
    assert rules == {r[1] for r in ref_analysis.registry.rule_catalog()}


def test_registry_select_by_rule_and_unknown():
    assert [p.name for p in create_passes(["clock"])] == \
        ["clock-discipline"]
    assert [p.name for p in create_passes(["host-sync"])] == \
        ["torch-hotpath"]
    with pytest.raises(KeyError):
        create_passes(["no-such-rule"])


# ----------------------------------------------------- lock-discipline

BAD_UNLOCKED = """
    import threading

    class Registry:
        def __init__(self):
            self._lock = threading.Lock()
            self._families = {}

        def add(self, name, fam):
            self._families[name] = fam
"""

CLEAN_LOCKED = """
    import threading

    class Registry:
        def __init__(self):
            self._lock = threading.Lock()
            self._families = {}

        def add(self, name, fam):
            with self._lock:
                self._families[name] = fam
"""


@pytest.mark.parametrize("pkg", PACKAGES)
def test_unlocked_mutation_flagged_and_fixed(pkg):
    bad = lint(BAD_UNLOCKED, f"{pkg}/obs/reg.py", ["lock-discipline"], pkg)
    assert rules_of(bad) == ["unlocked-mutation"]
    assert "_families" in bad.findings[0].message
    clean = lint(CLEAN_LOCKED, f"{pkg}/obs/reg.py", ["lock-discipline"],
                 pkg)
    assert clean.ok


BAD_ORDER = """
    import threading

    class Two:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()
            self._families = {}

        def one(self):
            with self._a:
                with self._b:
                    self._families["x"] = 1

        def other(self):
            with self._b:
                with self._a:
                    self._families["y"] = 2
"""


@pytest.mark.parametrize("pkg", PACKAGES)
def test_lock_order_inversion_flagged(pkg):
    bad = lint(BAD_ORDER, f"{pkg}/obs/two.py", ["lock-discipline"], pkg)
    assert "lock-order" in rules_of(bad)
    msg = " ".join(f.message for f in bad.findings
                   if f.rule == "lock-order")
    assert "_a" in msg and "_b" in msg
    clean_src = BAD_ORDER.replace(
        "with self._b:\n                with self._a:",
        "with self._a:\n                with self._b:")
    clean = lint(clean_src, f"{pkg}/obs/two.py", ["lock-discipline"], pkg)
    assert "lock-order" not in rules_of(clean)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_nonreentrant_self_nesting_flagged(pkg):
    src = """
        import threading

        class Once:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    self._g()

            def _g(self):
                with self._lock:
                    pass
    """
    bad = lint(src, f"{pkg}/obs/once.py", ["lock-discipline"], pkg)
    assert "lock-order" in rules_of(bad)
    clean = lint(src.replace("threading.Lock()", "threading.RLock()"),
                 f"{pkg}/obs/once.py", ["lock-discipline"], pkg)
    assert clean.ok


@pytest.mark.parametrize("pkg", PACKAGES)
def test_helper_mutation_covered_by_caller_lock_is_clean(pkg):
    src = """
        import threading

        class Store:
            def __init__(self):
                self._lock = threading.Lock()
                self._pending = []

            def push(self, x):
                with self._lock:
                    self._push_locked(x)

            def _push_locked(self, x):
                self._pending.append(x)
    """
    assert lint(src, f"{pkg}/obs/store.py", ["lock-discipline"], pkg).ok


# -------------------------------------------------------- wal-ordering

BAD_WAL = """
    class Store:
        def append(self, batch):
            self._pending.extend(batch)
            self._persist.log_pending(batch)
"""

CLEAN_WAL = """
    class Store:
        def append(self, batch):
            self._persist.log_pending(batch)
            self._pending.extend(batch)
"""


@pytest.mark.parametrize("pkg", PACKAGES)
def test_wal_order_ack_before_log_flagged(pkg):
    path = f"{pkg}/serving/ingest.py"
    bad = lint(BAD_WAL, path, ["wal-ordering"], pkg)
    assert rules_of(bad) == ["wal-order"]
    assert lint(CLEAN_WAL, path, ["wal-ordering"], pkg).ok
    assert rules_of(lint(BAD_WAL, f"{pkg}/persist/recovery.py",
                         ["wal-ordering"], pkg)) == ["wal-order"]
    # out of scope: same bad code elsewhere is not this pass's business
    assert lint(BAD_WAL, f"{pkg}/core/store.py", ["wal-ordering"], pkg).ok
    assert lint(BAD_WAL, f"{pkg}/persist/wal.py", ["wal-ordering"], pkg).ok


@pytest.mark.parametrize("pkg", PACKAGES)
def test_wal_order_drain_rebind_is_not_an_ack(pkg):
    src = """
        class Store:
            def swap(self):
                pending, self._pending = self._pending, []
                self._persist.log_drain(len(pending))
                return pending
    """
    assert lint(src, f"{pkg}/serving/ingest.py", ["wal-ordering"], pkg).ok


# -------------------------------------------------- epoch-immutability

BAD_EPOCH = """
    def rewrite(view):
        view.segments = []
        view._cache = {}
"""


@pytest.mark.parametrize("pkg", PACKAGES)
def test_epoch_freeze_write_from_non_owner_flagged(pkg):
    bad = lint(BAD_EPOCH, f"{pkg}/serving/frontend.py",
               ["epoch-immutability"], pkg)
    assert rules_of(bad) == ["epoch-freeze"]
    assert len(bad.findings) == 2
    # the owners may write the same state
    assert lint(BAD_EPOCH, f"{pkg}/core/segments.py",
                ["epoch-immutability"], pkg).ok
    assert lint(BAD_EPOCH, f"{pkg}/core/store.py",
                ["epoch-immutability"], pkg).ok


@pytest.mark.parametrize("pkg", PACKAGES)
def test_epoch_freeze_ignores_unrelated_receivers(pkg):
    src = """
        def local_work(self):
            self.t_min = 3          # not a segment/view receiver
            batch.ops = []          # not a hinted name
    """
    assert lint(src, f"{pkg}/serving/frontend.py",
                ["epoch-immutability"], pkg).ok


# ------------------------------------------------------- torch-hotpath

BAD_SYNC = """
    import torch

    def hot(x):
        return x.sum().item()
"""

SUPPRESSED_SYNC = """
    import torch

    def hot(x):
        return x.sum().item()  # graphlint: ignore[host-sync] one read a call, sizes the launch
"""

CLEAN_SYNC = """
    import torch

    def hot(x):
        return torch.sum(x * x)
"""

#: every module the pass scopes, as a path under the port
SCOPED = ["repro_torch/kernels/delta_apply/ops.py",
          "repro_torch/models/attention.py", "repro_torch/runtime/steps.py",
          "repro_torch/core/engine.py", "repro_torch/core/distributed.py"]


@pytest.mark.parametrize("path", SCOPED)
def test_host_sync_on_device_value_flagged(path):
    src = BAD_SYNC.replace("x.sum()", "torch.as_tensor(x).sum()")
    bad = lint(src, path, ["torch-hotpath"])
    assert rules_of(bad) == ["host-sync"]
    assert ".item()" in bad.findings[0].message
    rep = lint(SUPPRESSED_SYNC.replace("x.sum()",
                                       "torch.as_tensor(x).sum()"),
               path, ["torch-hotpath"])
    assert rep.ok and len(rep.suppressed) == 1
    assert rep.suppressed[0][1] == "one read a call, sizes the launch"
    assert lint(CLEAN_SYNC, path, ["torch-hotpath"]).ok
    # plain host ints are not device values
    assert lint("def f(t):\n    return int(t)\n", path,
                ["torch-hotpath"]).ok


def test_host_sync_scope():
    src = "import torch\n\ndef f(x):\n    return torch.ones(3).sum().item()\n"
    assert not lint(src, "repro_torch/kernels/k/ops.py", ["host-sync"]).ok
    # out of scope: serving, the store, and kernels/ outside the port
    for path in ("repro_torch/serving/frontend.py",
                 "repro_torch/core/store.py", "other/kernels/k/ops.py"):
        assert lint(src, path, ["host-sync"]).ok, path
    # the reference's pass scopes kernels/ only under a ``repro``
    # component, and its sources are jnp / lax / pl: it sees nothing here
    assert lint(src, "repro_torch/kernels/k/ops.py", ["host-sync"],
                "repro").ok


@pytest.mark.parametrize("sink", [
    "int(y)", "float(y)", "bool(y)", "np.asarray(y)", "np.array(y)",
    "y.item()", "y.tolist()", "y.cpu()", "y.numpy()",
    "torch.cuda.synchronize()"])
def test_host_sync_sinks(sink):
    """Every sink over a tensor: the torch-rooted call, a tensor method
    of it, an annotated parameter, a loop over it, a delta field."""
    for source in ("torch.zeros(4)", "x * 2", "x.sum()", "delta.t[0]",
                   "F.relu(x)"):
        src = f"""
            import numpy as np
            import torch
            import torch.nn.functional as F

            def f(x: torch.Tensor, delta):
                y = {source}
                return {sink}
        """
        rep = lint(src, "repro_torch/kernels/k/ops.py", ["host-sync"])
        assert rules_of(rep) == ["host-sync"], (source, sink)
    loop = f"""
        import numpy as np
        import torch

        def f(xs: torch.Tensor):
            for y in xs:
                {sink}
    """
    assert rules_of(lint(loop, "repro_torch/models/m.py",
                         ["host-sync"])) == ["host-sync"]


def test_host_valued_calls_and_attributes_are_clean():
    src = """
        import torch

        def f(x: torch.Tensor, n):
            a = int(x.shape[0]) + int(x.numel()) + int(x.size(1))
            b = int(torch.cuda.device_count()) + x.dim()
            dev = torch.device("cuda")
            free = int(torch.cuda.mem_get_info(dev)[0])
            return a + b + free + int(n) + bool(x.is_cuda)
    """
    assert lint(src, "repro_torch/core/engine.py", ["host-sync"]).ok


@pytest.mark.parametrize("decorator", [
    "@torch.compile", "@torch.compile(mode='max-autotune')",
    "@torch.jit.script", "@functools.partial(torch.compile, dynamic=True)"])
def test_jit_unhashable_default_flagged(decorator):
    src = f"""
        import functools
        import torch

        {decorator}
        def f(x, opts={{}}):
            return x
    """
    bad = lint(src, "repro_torch/core/engine.py", ["torch-hotpath"])
    assert "jit-unhashable-default" in rules_of(bad)
    clean = src.replace("opts={}", "opts=None")
    assert lint(clean, "repro_torch/core/engine.py", ["torch-hotpath"]).ok
    # an uncompiled function may keep any default
    plain = src.replace(decorator, "")
    assert lint(plain, "repro_torch/core/engine.py", ["torch-hotpath"]).ok


# ----------------------------------------------------- clock-discipline

BAD_CLOCK = """
    import time

    def stamp():
        return time.time()
"""


@pytest.mark.parametrize("pkg", PACKAGES)
def test_clock_rule_scope_and_fix(pkg):
    bad = lint(BAD_CLOCK, f"{pkg}/core/metrics_user.py",
               ["clock-discipline"], pkg)
    assert rules_of(bad) == ["clock"]
    # obs/ owns the clock; same code there is fine
    assert lint(BAD_CLOCK, f"{pkg}/obs/clock.py", ["clock-discipline"],
                pkg).ok
    clean = f"""
        from {pkg}.obs import clock

        def stamp():
            return clock.now()
    """
    assert lint(clean, f"{pkg}/core/metrics_user.py", ["clock-discipline"],
                pkg).ok
    # each package's rule covers its own tree
    other = "repro_torch" if pkg == "repro" else "repro"
    assert lint(BAD_CLOCK, f"{other}/core/metrics_user.py",
                ["clock-discipline"], pkg).ok


@pytest.mark.parametrize("pkg", PACKAGES)
def test_clock_rule_catches_from_import_and_datetime(pkg):
    src = """
        from time import perf_counter
        import datetime

        def f():
            return perf_counter(), datetime.datetime.now()
    """
    bad = lint(src, f"{pkg}/core/x.py", ["clock-discipline"], pkg)
    assert rules_of(bad) == ["clock"]
    assert len(bad.findings) >= 2


# --------------------------------------------------------- suppression

@pytest.mark.parametrize("pkg", PACKAGES)
def test_suppression_moves_finding_and_keeps_reason(pkg):
    src = """
        import time

        def stamp():
            return time.time()  # graphlint: ignore[clock] boot banner only
    """
    rep = lint(src, f"{pkg}/core/x.py", ["clock-discipline"], pkg)
    assert rep.ok
    assert len(rep.suppressed) == 1
    finding, reason = rep.suppressed[0]
    assert finding.rule == "clock"
    assert reason == "boot banner only"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_suppression_standalone_line_and_star(pkg):
    src = """
        import time

        def stamp():
            # graphlint: ignore[*] measured host wall time on purpose
            return time.time()
    """
    rep = lint(src, f"{pkg}/core/x.py", ["clock-discipline"], pkg)
    assert rep.ok and len(rep.suppressed) == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_suppression_for_other_rule_does_not_apply(pkg):
    src = """
        import time

        def stamp():
            return time.time()  # graphlint: ignore[wal-order] wrong rule
    """
    rep = lint(src, f"{pkg}/core/x.py", ["clock-discipline"], pkg)
    assert not rep.ok


# ----------------------------------------------------------------- CLI

def run_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=ROOT, env=env)


def test_cli_exit_codes(tmp_path):
    pkg = tmp_path / "repro_torch" / "kernels"
    pkg.mkdir(parents=True)
    bad = pkg / "bad.py"
    bad.write_text("import torch\n\ndef f(x):\n"
                   "    return torch.sum(x).item()\n")
    proc = run_cli(str(tmp_path))
    assert proc.returncode == 1
    assert "host-sync" in proc.stdout

    bad.write_text("import torch\n\ndef f(x):\n"
                   "    return torch.sum(x).item()  "
                   "# graphlint: ignore[host-sync] one read a call\n")
    proc = run_cli(str(tmp_path))
    assert proc.returncode == 0
    assert "0 findings, 1 suppressed" in proc.stdout

    assert run_cli("--list").returncode == 0
    assert run_cli("--select", "bogus", str(tmp_path)).returncode == 2
    assert run_cli("--select", "host-sync", str(tmp_path)).returncode == 0


def test_cli_json_format(tmp_path):
    pkg = tmp_path / "serving"
    pkg.mkdir(parents=True)
    (pkg / "ingest.py").write_text(textwrap.dedent("""
        class S:
            def append(self, b):
                self._pending.extend(b)
                self._persist.log_pending(b)
    """))
    proc = run_cli("--format", "json", str(tmp_path))
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert payload["findings"][0]["rule"] == "wal-order"
    assert payload["files"] == 1


def test_repo_is_clean():
    """The port's tree has zero unsuppressed findings under its own
    analyzer (what ``python -m repro_torch.analysis`` checks by
    default); every suppression carries a reason."""
    rep = analyze_paths([os.path.join(ROOT, "src", "repro_torch")])
    assert rep.ok, "\n" + "\n".join(f.render() for f in rep.findings)
    for finding, reason in rep.suppressed:
        assert reason.strip(), f"suppression without reason: {finding}"
    assert run_cli().returncode == 0


# ------------------------------------------------------------- lockdep

@pytest.fixture
def sanitizer():
    """Fresh lockdep session of the port's copy."""
    was = lockdep.enabled()
    if was:
        lockdep.disable()
    lockdep.enable()
    try:
        yield lockdep
    finally:
        lockdep.disable()
        if was:
            lockdep.enable()


def test_lockdep_detects_ab_ba_inversion_deterministically(sanitizer):
    a = threading.Lock()
    b = threading.Lock()
    raised = []

    def first():
        with a:
            with b:
                pass

    def second():
        try:
            with b:
                with a:
                    pass
        except lockdep.LockOrderError as exc:
            raised.append(str(exc))

    t1 = threading.Thread(target=first)
    t1.start()
    t1.join(timeout=5)
    t2 = threading.Thread(target=second)
    t2.start()
    t2.join(timeout=5)
    assert not t1.is_alive() and not t2.is_alive()
    assert len(raised) == 1
    assert "inversion" in raised[0]
    assert len(sanitizer.order_graph()) >= 1


def test_lockdep_consistent_order_and_rlock_reentry(sanitizer):
    a = threading.Lock()
    r = threading.RLock()
    with a:
        with r:
            with r:            # re-entry: no edge, no error
                pass
    with a:
        with r:
            pass               # same order again: fine
    g = sanitizer.order_graph()
    assert any(g.values())


def test_lockdep_self_deadlock_raises_instead_of_hanging(sanitizer):
    lk = threading.Lock()
    lk.acquire()
    with pytest.raises(lockdep.LockOrderError, match="self-deadlock"):
        lk.acquire()
    assert lk.acquire(blocking=False) is False
    lk.release()


def test_lockdep_condition_wait_keeps_bookkeeping(sanitizer):
    cv = threading.Condition()
    done = []

    def waiter():
        with cv:
            while not done:
                cv.wait(timeout=2)

    t = threading.Thread(target=waiter)
    t.start()
    with cv:
        done.append(1)
        cv.notify_all()
    t.join(timeout=5)
    assert not t.is_alive()


def test_lockdep_reset_forgets_history(sanitizer):
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    sanitizer.reset()
    with b:
        with a:                # inverse of pre-reset order: no error
            pass
    assert sanitizer.order_graph() != {}


def test_lockdep_disable_restores_real_primitives():
    was = lockdep.enabled()
    if was:
        lockdep.disable()
    real = threading.Lock
    lockdep.enable()
    assert threading.Lock is not real
    lockdep.disable()
    assert threading.Lock is real
    if was:
        lockdep.enable()
