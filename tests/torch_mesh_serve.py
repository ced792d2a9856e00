"""Prefill and greedy decode on a ``DeviceMesh``, shared by the gloo
groups of ``test_torch_sharding.py`` (the dense, encdec and vlm
families) and ``test_torch_expert_parallel.py`` (moe, ssm, hybrid): the
worker side
(``serve_on_mesh``, importing only ``repro_torch``), the single-device
JAX oracle (``jax_serve``) and the single-device port (``port_serve``),
both run in the parent process, and the checks (``check_served``).

Each case is a (mesh, batch) pair: batch 8 splits the batch over the
``batch`` axes; batch 2 does not divide them, so the caches split their
KV sequence over ``kv_seq`` (asserted from the placements).  A batch is
a dict of ``tokens`` and the family's stub input (``frames`` for
encdec, ``patches`` for vlm), each cut to the case's first rows.  A
model with a sliding window gets a cache cap below the prompt, so that
its ring buffer wraps across the sequence shards; any other a cap of
the prefix (the vlm's patches), the prompt and the steps rounded up to
a multiple of 8; decode positions count the prefix.
"""
import numpy as np

# (mesh, batch) of the serving runs
CASES = (("4x2", 8), ("2x4", 8), ("8x1", 8), ("4x2", 2), ("8x1", 2))
DECODE_STEPS = 4
# test_torch_lm.py's bound on logits, and on every cache leaf against
# JAX's; an SSM ``state`` leaf is held to it relative to its largest
# entry where that is above 1 (the reduced jamba's states reach 22, and
# float32 sums in other orders move them by that much more: the port's
# own drift from JAX, which MESH_RTOL below keeps apart from the mesh's)
TOL = 1e-4
# the mesh against the single-device port on the same parameters and
# tokens: logits and every cache leaf within MESH_RTOL of the leaf's
# largest entry (at least 1).  A process's few rows sum in float32 in
# other orders than the port's whole batch does, as the port alone does
# when it runs the first row of a batch on its own
MESH_RTOL = 1e-5


def cache_cap(cfg, prompt: int) -> int:
    """Below the prompt for a windowed model (its ring wraps); else the
    prompt and the decode steps, rounded up to a multiple of 8.
    ``prompt`` counts the prefix."""
    if cfg.window is not None:
        return prompt - 8
    return -(-(prompt + DECODE_STEPS) // 8) * 8


def prefix_len(cfg) -> int:
    """The positions before the prompt's tokens: the vlm's patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def first_rows(batch: dict, b: int) -> dict:
    return {k: v[:b] for k, v in batch.items()}


def case_name(mesh: str, batch: int) -> str:
    return f"{mesh}_b{batch}"


def _flat(caches: dict, prefix: str) -> dict:
    """``convert.caches_to_numpy``'s nested dict as flat npz entries."""
    out = {}
    for name, entry in caches.items():
        if isinstance(entry, dict):
            for field, a in entry.items():
                out[f"{prefix}/{name}/{field}"] = a
        else:
            out[f"{prefix}/{name}"] = entry
    return out


def serve_on_mesh(model, batch, cfg, mesh=None) -> tuple[dict, dict]:
    """``api.prefill`` and ``DECODE_STEPS`` greedy ``api.decode_step``s
    of ``model`` (placed on ``mesh`` by the parameter rules) over
    ``batch`` (placed by ``batch_sharding``), in the mesh's context;
    with no ``mesh``, on the one device.  Returns (arrays: every step's
    logits, the greedy tokens, the caches gathered after the prefill and
    after the last step; facts: the cache leaves not at
    ``cache_sharding``'s placement after each call, whether the k caches
    split their sequence)."""
    import contextlib

    import torch

    from repro_torch.convert import caches_to_numpy
    from repro_torch.launch.dryrun import (batch_sharding, cache_leaves,
                                           cache_sharding)
    from repro_torch.models import api
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import mesh_context

    prompt = prefix_len(cfg) + batch["tokens"].shape[1]
    cap = cache_cap(cfg, prompt)
    misplaced, logits, chosen = [], [], []

    def read(lg, caches, when):
        if mesh is not None:
            want = cache_sharding(caches, mesh)
            misplaced.extend(
                f"{when}: {n}" for n, _, leaf in cache_leaves(caches)
                if tuple(leaf.placements) != want[n].placements)
            lg = lg.full_tensor()
        logits.append(lg.numpy())
        chosen.append(lg.argmax(-1).to(torch.int32))
        return chosen[-1]

    if mesh is not None:
        batch = place_tree(batch, batch_sharding(batch, mesh))
    with mesh_context(mesh) if mesh is not None else \
            contextlib.nullcontext():
        lg, caches = api.prefill(model, batch, cfg, cache_cap=cap)
        tok = read(lg, caches, "prefill")
        arrays = _flat(caches_to_numpy(caches), "prefill")
        for i in range(DECODE_STEPS):
            lg, caches = api.decode_step(model, tok[:, None], prompt + i,
                                         caches, cfg)
            tok = read(lg, caches, f"step {i}")
    arrays.update(_flat(caches_to_numpy(caches), "last"))
    arrays["logits"] = np.stack(logits)
    arrays["tokens"] = torch.stack(chosen).numpy()
    seq_split = mesh is not None and any(
        str(leaf.placements).count("Shard(dim=1)")
        for n, _, leaf in cache_leaves(caches) if n.endswith("/k"))
    return arrays, dict(misplaced=misplaced, seq_split=bool(seq_split))


def serve_cases(model, batch, cfg, meshes: dict, out: str, tag: str,
                rank: int) -> dict:
    """``serve_on_mesh`` for every case of ``CASES`` (the first rows of
    ``batch``); rank 0 writes each case's arrays to
    ``<out>/serve_<tag>_<case>.npz``.  Returns {case: facts}."""
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import named_shardings
    placed, facts = {}, {}
    for name, b in CASES:
        if name not in placed:
            placed[name] = place_tree(model,
                                      named_shardings(model, meshes[name]))
        arrays, facts[case_name(name, b)] = serve_on_mesh(
            placed[name], first_rows(batch, b), cfg, meshes[name])
        if rank == 0:
            np.savez(f"{out}/serve_{tag}_{case_name(name, b)}.npz", **arrays)
    return facts


def port_serve(params, batch, cfg) -> dict:
    """``serve_on_mesh`` on one device for each batch of ``CASES``: the
    single-device port, run in the parent process.  Returns {batch:
    arrays}."""
    return {b: serve_on_mesh(params, first_rows(batch, b), cfg)[0]
            for b in sorted({b for _, b in CASES})}


def jax_serve(jparams, jbatch, jcfg) -> dict:
    """The single-device JAX oracle of ``serve_on_mesh`` for each batch
    of ``CASES``: ``api.prefill`` and greedy ``api.decode_step``s, each
    fed its own greedy tokens.  Returns {batch: arrays as
    ``serve_on_mesh`` names them}, the caches through
    ``convert.caches_from_numpy`` / ``caches_to_numpy``."""
    import jax
    import jax.numpy as jnp

    from repro.models import api as japi
    from repro_torch.convert import caches_from_numpy, caches_to_numpy

    def port_form(caches, prefix):
        return _flat(caches_to_numpy(caches_from_numpy(
            jax.tree.map(np.asarray, caches), device="cpu")), prefix)

    prompt = prefix_len(jcfg) + jbatch["tokens"].shape[1]
    cap = cache_cap(jcfg, prompt)
    prefill = jax.jit(lambda p, bt: japi.prefill(p, bt, jcfg, cache_cap=cap))
    step = jax.jit(lambda p, t, pos, c: japi.decode_step(p, t, pos, c, jcfg))
    out = {}
    for b in sorted({b for _, b in CASES}):
        lg, caches = prefill(jparams, first_rows(jbatch, b))
        arrays = port_form(caches, "prefill")
        logits, chosen = [np.asarray(lg)], [np.asarray(jnp.argmax(lg, -1))]
        for i in range(DECODE_STEPS):
            tok = jnp.asarray(chosen[-1], jnp.int32)[:, None]
            lg, caches = step(jparams, tok, jnp.int32(prompt + i), caches)
            logits.append(np.asarray(lg))
            chosen.append(np.asarray(jnp.argmax(lg, -1)))
        arrays.update(port_form(caches, "last"))
        arrays["logits"] = np.stack(logits)
        arrays["tokens"] = np.stack(chosen).astype(np.int32)
        out[b] = arrays
    return out


def check_served(got, want: dict, port: dict, facts: dict,
                 batch: int) -> None:
    """A case's arrays against the single-device JAX oracle's (``want``)
    and the single-device port's (``port``): logits within ``TOL`` of
    JAX's, the same greedy tokens, every cache leaf within ``TOL`` of
    JAX's (an SSM ``state`` relative to its largest entry above 1) and
    ``pos_map`` bit-equal; logits and every cache leaf within
    ``MESH_RTOL`` of the port's (``pos_map`` bit-equal); every leaf at
    ``cache_sharding``'s placement after each call, the KV sequence
    split (where there are KV caches) exactly where the batch does not
    divide the batch axes (batch 2)."""
    assert facts["misplaced"] == [], facts["misplaced"][:5]
    has_kv = any(k.endswith("/k") for k in want)
    assert facts["seq_split"] == (has_kv and batch == 2), facts
    d = float(np.abs(got["logits"] - want["logits"]).max())
    assert d <= TOL, ("logits", d)
    assert _within(got["logits"], port["logits"], MESH_RTOL), "logits"
    assert np.array_equal(got["tokens"], want["tokens"])
    caches = {k for k in want if k.startswith(("prefill/", "last/"))}
    assert caches == {k for k in got.files
                      if k.startswith(("prefill/", "last/"))} == {
        k for k in port if k.startswith(("prefill/", "last/"))}
    for k in sorted(caches):
        if k.endswith("/pos_map"):
            assert np.array_equal(got[k], want[k]), k
            assert np.array_equal(got[k], port[k]), k
            continue
        if k.endswith("/state"):
            assert _within(got[k], want[k], TOL), k
        else:
            d = float(np.abs(got[k] - want[k]).max())
            assert d <= TOL, (k, d)
        assert _within(got[k], port[k], MESH_RTOL), (k, "against the port")


def _within(got, want, rtol: float) -> bool:
    """|got - want| within ``rtol`` of want's largest entry, at least 1."""
    return float(np.abs(got - want).max()) <= rtol * max(
        1.0, float(np.abs(want).max()))
