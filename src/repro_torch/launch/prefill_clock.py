"""Time the bf16 prefill of served models at published width on one card.

For each ``--arch``: weights drawn from a seeded generator, a batch of
``--batch`` × ``--prompt`` random tokens, one cold prefill, then
``--reps`` warm prefills, each timed on the host's clock between two
device synchronisations.  Prints one JSON object: per arch the cold
seconds, every warm prefill's milliseconds with their median and mean,
and the kernels' launches a prefill.

The module imports only ``models.api``, ``configs`` and
``kernels.build``, so it can time another checkout of the port: run it
by path with that checkout's ``src`` on ``PYTHONPATH``, e.g.

    PYTHONPATH=other/src python src/repro_torch/launch/prefill_clock.py \\
        --arch smollm-360m mamba2-130m
"""
from __future__ import annotations

import argparse
import json
import statistics


def clock(arch: str, *, batch: int, prompt: int, reps: int,
          seed: int) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.obs.clock import now

    cfg = get_config(arch)
    dev = torch.device("cuda")
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                            torch.bfloat16, dev)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt),
                           generator=torch.Generator().manual_seed(seed)
                           ).to(dev)

    def prefill():
        torch.cuda.synchronize()
        t0 = now()
        api.prefill(model, {"tokens": tokens}, cfg, cache_cap=prompt)
        torch.cuda.synchronize()
        return now() - t0

    cold_s = prefill()
    build.reset_launches()
    warm_ms = [prefill() * 1e3 for _ in range(reps)]
    return dict(arch=arch, n_layers=cfg.n_layers, batch=batch, prompt=prompt,
                cold_s=cold_s, warm_ms=warm_ms,
                median_ms=statistics.median(warm_ms),
                mean_ms=statistics.fmean(warm_ms),
                launches_per_prefill={k: v // reps
                                      for k, v in build.LAUNCHES.items()
                                      if v})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+",
                    default=["smollm-360m", "mamba2-130m"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    from repro_torch.kernels import build
    build.ext()
    out = dict(tag=args.tag, runs=[clock(a, batch=args.batch,
                                         prompt=args.prompt, reps=args.reps,
                                         seed=args.seed)
                                   for a in args.arch])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
