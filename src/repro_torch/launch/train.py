"""The training loop with delta-based checkpointing,
historical metric logging, failure recovery and straggler-policy hooks
— counterpart of ``repro/launch/train.py``, on one device.

    python -m repro_torch.launch.train --arch mamba2-130m --reduced \\
        --device cpu --steps 50 --ckpt /tmp/ckpt     # the plain versions
    python -m repro_torch.launch.train --arch smollm-360m --steps 100 \\
        --batch 8 --seq 2048                          # on the card

The step time (``step_ms`` in the history) is read on the host clock
after the device has finished the step.

``train(..., mesh=)`` trains on a ``DeviceMesh`` (``launch/mesh.py``;
one process a device, every process calling ``train``): the state is
placed by the param rules (``runtime.elastic.reshard_state``), each
batch by ``launch.dryrun.batch_sharding``, and every step runs inside
``sharding.mesh_context``.  A checkpoint store then holds the gathered
state, written by every process: give each its own ``ckpt_dir``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (DeltaCheckpointStore, DeltaPolicy,
                                    HistoryLog, tensor_measures)
from repro_torch.config import ShardingConfig, TrainConfig, reduced
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.dryrun import batch_sharding
from repro_torch.obs import clock
from repro_torch.runtime import (FailureInjector, TrainState,
                                 init_train_state, make_train_step,
                                 reshard_state, run_with_recovery)
from repro_torch.runtime.elastic import place_tree
from repro_torch.runtime.stragglers import StragglerPolicy
from repro_torch.sharding import mesh_context


def train(cfg, tcfg: TrainConfig, scfg: ShardingConfig, *, device="cuda",
          ckpt_dir: str | None = None, ckpt_every: int = 20,
          policy: DeltaPolicy | None = None,
          injector: FailureInjector | None = None,
          history: HistoryLog | None = None,
          log_every: int = 10, straggler: StragglerPolicy | None = None,
          log_tensor_norms: bool = False, mesh=None):
    """Returns (final TrainState, HistoryLog, DeltaCheckpointStore|None).

    Recovery contract: if any step raises, re-enter with the store's
    latest state (runtime/failures.py) — this function does exactly
    that internally when a checkpoint store is present.
    """
    dev = resolve_device(device)
    data = SyntheticLM(cfg, tcfg.global_batch, tcfg.seq_len,
                       seed=tcfg.seed, device=dev)
    step_fn = make_train_step(cfg, tcfg, scfg)
    store = (DeltaCheckpointStore(ckpt_dir, policy)
             if ckpt_dir else None)
    history = history or HistoryLog()

    def loop(start_step: int) -> TrainState:
        state = init_train_state(cfg, tcfg, device=dev)
        if start_step != 0 and store is not None and \
                store.latest_step() is not None:
            state = store.restore(store.latest_step(), state)
            start_step = state.step
        if mesh is not None:
            state = reshard_state(state, mesh)
        for step in range(start_step, tcfg.total_steps):
            if injector is not None:
                injector.check(step)
            t0 = clock.now()
            batch = data.batch_at(step)
            if mesh is None:
                state, metrics = step_fn(state, batch)
            else:
                with mesh_context(mesh):
                    state, metrics = step_fn(state, place_tree(
                        batch, batch_sharding(batch, mesh)))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt_ms = (clock.now() - t0) * 1e3
            if step % log_every == 0 or step == tcfg.total_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step_ms"] = dt_ms
                if log_tensor_norms:
                    m.update(tensor_measures(state.params))
                history.record(step, m)
            if store is not None and step % ckpt_every == 0:
                store.save(step, state)
            if straggler is not None:
                straggler.observe(dt_ms, tcfg.microbatches)
        if store is not None:
            store.save(tcfg.total_steps - 1, state)
        return state

    if store is not None:
        state = run_with_recovery(loop, store, None)
    else:
        state = loop(0)
    return state, history, store


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--policy", default="periodic",
                    choices=["periodic", "opcount", "similarity"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                       lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       param_dtype="float32")
    scfg = ShardingConfig()
    t0 = clock.now()
    state, history, store = train(
        cfg, tcfg, scfg, device=args.device, ckpt_dir=args.ckpt,
        ckpt_every=args.ckpt_every, policy=DeltaPolicy(kind=args.policy))
    first = history.rows["loss"][0]
    last = history.rows["loss"][-1]
    print(f"trained {args.steps} steps in {clock.now()-t0:.1f}s on "
          f"{args.device} | loss {first:.4f} -> {last:.4f}")
    if store is not None:
        print("checkpoint storage:", store.storage_bytes())


if __name__ == "__main__":
    main()
