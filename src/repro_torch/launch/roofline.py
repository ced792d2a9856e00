"""Roofline analysis — counterpart of ``repro/launch/roofline.py``.

Hardware model (NVIDIA H100 80GB HBM3, 700 W: the H100 SXM5), per card:
  peak bf16 compute  : 989 TFLOP/s dense (NVIDIA's H100 data sheet)
  HBM bandwidth      : 3.35 TB/s (NVIDIA's H100 data sheet)
  collective         : 50 GB/s a card — one 400 Gb/s NDR InfiniBand
                       link a GPU (NVIDIA's DGX H100 reference design):
                       a 16 × 16 mesh spans 32 nodes of 8 cards, so
                       every axis of it crosses nodes

Terms (per-device program):
  compute    = flops / PEAK_FLOPS
  memory     = bytes_accessed / HBM_BW
  collective = collective_operand_bytes / ICI_BW

The port's dry-run (``launch/dryrun.py``) feeds ``roofline_terms`` and
``model_flops`` from counts of its own traced step.  Nothing in the
port produces HLO: the parsers (``shape_bytes``, ``collective_bytes``,
``scan_aware_metrics``) are the reference's, kept so that this module
matches it, and are held to it on synthetic HLO
(``tests/test_torch_roofline.py``): the sum of *operand* sizes of every
all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute (two-pass parse: instruction table → operand
lookup).
"""
from __future__ import annotations

import re
from typing import Any

PEAK_FLOPS = 989e12    # dense bf16, NVIDIA H100 SXM5 data sheet
HBM_BW = 3.35e12       # HBM3, NVIDIA H100 SXM5 data sheet
ICI_BW = 50e9          # one 400 Gb/s NDR link a GPU (DGX H100 design)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+?)\[([\d,]*)\]")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(\(?[^)=]*?\)?)\s*"
                       r"([\w\-]+)\(", re.M)
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string (tuples summed)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> dict[str, Any]:
    """Sum of operand bytes per collective kind, from compiled HLO."""
    # pass 1: instruction table name -> result bytes
    table: dict[str, int] = {}
    for m in _INSTR_RE.finditer(hlo_text):
        name, type_str, _op = m.group(1), m.group(2), m.group(3)
        table[name] = shape_bytes(type_str)

    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for m in _INSTR_RE.finditer(hlo_text):
        name, type_str, op = m.group(1), m.group(2), m.group(3)
        kind = None
        for c in _COLLECTIVES:
            if op == c or op == c + "-start":
                kind = c
                break
        if kind is None:
            continue
        # operands: %refs inside the call parens on this line
        line_start = m.end()
        line_end = hlo_text.find("\n", line_start)
        args = hlo_text[line_start:line_end]
        args = args.split(")")[0]
        operand_bytes = 0
        for ref in re.findall(r"%([\w\.\-]+)", args):
            operand_bytes += table.get(ref, 0)
        if operand_bytes == 0:  # operands not resolvable: use result
            operand_bytes = shape_bytes(type_str)
        out[kind] += operand_bytes
        counts[kind] += 1
    out_total = sum(out.values())
    return {"per_kind": out, "counts": counts, "total": out_total}


# ---------------------------------------------------------------------------
# Scan-aware HLO analysis
# ---------------------------------------------------------------------------
#
# XLA's HloCostAnalysis counts a while-loop body ONCE — with scan-over-
# layers that understates per-step work by n_layers×.  We therefore
# re-derive the roofline inputs from the compiled HLO text:
#   * per-computation dot FLOPs (2 · prod(result dims) · prod(contract)),
#   * per-computation top-level bytes (fusion-internal ops excluded —
#     fusions count as one op with operand+result bytes, matching the
#     HBM-traffic model),
#   * per-computation collective operand bytes,
# then roll up: entry ×1, while bodies × trip count (parsed from the
# loop-condition constant), computations called by fusions/reducers ×0.

_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s+\([^)]*\)\s*->",
                      re.M)
_FULL_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(\(?[^)=]*?\)?)\s*([\w\-]+)"
    r"\((.*)$", re.M)


def _split_computations(text: str) -> dict[str, str]:
    """computation name -> body text."""
    comps = {}
    cur = None
    buf: list[str] = []
    for line in text.splitlines():
        m = re.match(r"^(ENTRY\s+)?%?([\w\.\-]+)\s+\(.*->.*\{\s*$",
                     line)
        if m:
            if cur is not None:
                comps[cur] = "\n".join(buf)
            cur = m.group(2)
            if m.group(1):
                comps["__entry__"] = cur
            buf = []
        elif cur is not None:
            buf.append(line)
    if cur is not None:
        comps[cur] = "\n".join(buf)
    return comps


def _dot_flops(body: str, table: dict[str, int],
               shapes: dict[str, list[tuple[str, list[int]]]]) -> float:
    flops = 0.0
    for m in _FULL_INSTR_RE.finditer(body):
        name, type_str, op, rest = m.groups()
        if op != "dot":
            continue
        res_dims = 1
        for _dt, dims in _SHAPE_RE.findall(type_str):
            for d in (dims.split(",") if dims else []):
                res_dims *= int(d)
        lhs = re.search(r"%([\w\.\-]+)", rest)
        cdims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rest)
        contract = 1
        if lhs and cdims and lhs.group(1) in shapes:
            lshape = shapes[lhs.group(1)]
            if lshape:
                dims = lshape[0][1]
                for ci in (cdims.group(1).split(",")
                           if cdims.group(1) else []):
                    ci = int(ci)
                    if ci < len(dims):
                        contract *= dims[ci]
        flops += 2.0 * res_dims * contract
    return flops


def _fusion_io_profiles(comps: dict[str, str], table) -> dict:
    """For every computation, the *effective* IO profile when called as
    a fusion:
      params: per-parameter effective read bytes — a parameter consumed
        only through ``dynamic-slice`` counts as the slice (XLA streams
        the slice; charging a 61-layer stacked buffer per scan
        iteration would inflate memory by n_layers×);
      out: effective written bytes — a ``dynamic-update-slice`` root is
        aliased in place, so traffic is the update operand, not the
        whole buffer.
    """
    out = {}
    for cname, body in comps.items():
        params: dict[int, int] = {}
        pnames: dict[str, int] = {}
        root_eff = None
        for m in _FULL_INSTR_RE.finditer(body):
            name, type_str, op, rest = m.groups()
            if op == "parameter":
                idx_m = re.match(r"\s*(\d+)", rest)
                if idx_m:
                    i = int(idx_m.group(1))
                    params[i] = shape_bytes(type_str)
                    pnames[name] = i
        # downgrade params only used via dynamic-slice
        uses: dict[int, list] = {i: [] for i in params}
        for m in _FULL_INSTR_RE.finditer(body):
            name, type_str, op, rest = m.groups()
            if op == "parameter":
                continue
            for ref in re.findall(r"%([\w\.\-]+)", rest.split(")")[0]):
                if ref in pnames:
                    uses[pnames[ref]].append((op, shape_bytes(type_str)))
        eff = dict(params)
        for i, us in uses.items():
            if us and all(op == "dynamic-slice" for op, _ in us):
                eff[i] = sum(b for _, b in us)
        # root DUS → effective out = update operand
        rm = re.search(r"ROOT\s+%?([\w\.\-]+)\s*=\s*(\(?[^)=]*?\)?)\s*"
                       r"([\w\-]+)\((.*)$", body, re.M)
        if rm and rm.group(3) == "dynamic-update-slice":
            ops_refs = re.findall(r"%([\w\.\-]+)",
                                  rm.group(4).split(")")[0])
            if len(ops_refs) >= 2:
                # update operand: local name → look in body table
                upd = ops_refs[1]
                for m in _FULL_INSTR_RE.finditer(body):
                    if m.group(1) == upd:
                        root_eff = 2 * shape_bytes(m.group(2))
                        break
                if root_eff is None and upd in pnames:
                    root_eff = 2 * params[pnames[upd]]
        out[cname] = {"params": eff, "out": root_eff}
    return out


def _comp_metrics(body: str, table, shapes, fusion_io=None) -> dict:
    """Top-level bytes / dot flops / collective bytes of one
    computation (fusion bodies are separate computations — not here).
    Fusion calls use the effective IO profile of the fused computation
    (_fusion_io_profiles); top-level dynamic-(update-)slice ops count
    slice traffic only."""
    fusion_io = fusion_io or {}
    bytes_acc = 0
    coll = 0
    for m in _FULL_INSTR_RE.finditer(body):
        name, type_str, op, rest = m.groups()
        if op in ("parameter", "constant", "get-tuple-element", "tuple",
                  "bitcast"):
            continue
        out_b = shape_bytes(type_str)
        refs = re.findall(r"%([\w\.\-]+)", rest.split(")")[0])
        in_b = sum(table.get(r, 0) for r in refs)
        total = out_b + in_b
        if op == "fusion":
            cm = re.search(r"calls=%?([\w\.\-]+)", rest)
            prof = fusion_io.get(cm.group(1)) if cm else None
            if prof:
                eff_in = sum(
                    prof["params"].get(i, table.get(r, 0))
                    for i, r in enumerate(refs))
                eff_out = prof["out"] if prof["out"] is not None \
                    else out_b
                total = eff_in + eff_out
        elif op == "dynamic-slice":
            total = 2 * out_b  # read slice + write slice
        elif op == "dynamic-update-slice":
            big = max((table.get(r, 0) for r in refs), default=0)
            total = max(out_b + in_b - big - out_b, 0)
        bytes_acc += max(total, 0)
        for c in _COLLECTIVES:
            if op == c or op == c + "-start":
                coll += in_b if in_b else out_b
                break
    return {"bytes": bytes_acc,
            "dot_flops": _dot_flops(body, table, shapes),
            "coll": coll}


def _trip_count(while_line: str, cond_body: str) -> int | None:
    """Trip count — prefer XLA's own ``known_trip_count`` backend
    config on the while instruction, fall back to the loop-condition
    comparison constant."""
    m = re.search(r'known_trip_count\\?":\s*\{\\?"n\\?":\s*\\?"(\d+)',
                  while_line)
    if m:
        return int(m.group(1))
    consts = re.findall(r"constant\((\d+)\)", cond_body)
    if re.search(r"compare\(", cond_body) and consts:
        return int(consts[-1])
    return None


def scan_aware_metrics(text: str, default_trips: int = 1) -> dict:
    """Whole-module {flops, bytes, coll_bytes} with while bodies scaled
    by their trip counts."""
    # instruction table across the whole module (names are unique)
    table: dict[str, int] = {}
    shapes: dict[str, list] = {}
    for m in _FULL_INSTR_RE.finditer(text):
        name, type_str = m.group(1), m.group(2)
        table[name] = shape_bytes(type_str)
        sh = []
        for dt, dims in _SHAPE_RE.findall(type_str):
            sh.append((dt, [int(d) for d in dims.split(",")]
                       if dims else []))
        shapes[name] = sh

    comps = _split_computations(text)
    entry = comps.pop("__entry__", None)

    # callee roles
    fused: set[str] = set()
    whiles: list[tuple[str, str]] = []   # (body, cond)
    for body in comps.values():
        for m in re.finditer(r"calls=%?([\w\.\-]+)", body):
            fused.add(m.group(1))
        for m in re.finditer(r"to_apply=%?([\w\.\-]+)", body):
            fused.add(m.group(1))
        for m in re.finditer(
                r"while\([^)]*\), condition=%?([\w\.\-]+), "
                r"body=%?([\w\.\-]+)", body):
            whiles.append((m.group(2), m.group(1)))

    # multipliers: start at entry ×1, propagate through while nesting
    mult: dict[str, float] = {}
    if entry in comps:
        mult[entry] = 1.0

    def visit(name: str, factor: float):
        if name not in comps:
            return
        body = comps[name]
        for line in body.splitlines():
            m = re.search(
                r"while\([^)]*\), condition=%?([\w\.\-]+), "
                r"body=%?([\w\.\-]+)", line)
            if not m:
                continue
            cond, wbody = m.group(1), m.group(2)
            trips = _trip_count(line, comps.get(cond, "")) \
                or default_trips
            mult[wbody] = mult.get(wbody, 0.0) + factor * trips
            visit(wbody, factor * trips)

    if entry in comps:
        mult[entry] = 1.0
        visit(entry, 1.0)

    fusion_io = _fusion_io_profiles(
        {k: v for k, v in comps.items() if k in fused}, table)

    total = {"flops": 0.0, "bytes": 0.0, "coll_bytes": 0.0}
    per_comp = {}
    for name, body in comps.items():
        f = mult.get(name, 0.0)
        if name == entry:
            f = 1.0
        if f == 0.0 or name in fused:
            continue
        met = _comp_metrics(body, table, shapes, fusion_io)
        per_comp[name] = {"mult": f, **met}
        total["flops"] += f * met["dot_flops"]
        total["bytes"] += f * met["bytes"]
        total["coll_bytes"] += f * met["coll"]
    total["per_comp"] = per_comp
    return total


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float) -> dict[str, float]:
    compute = flops / PEAK_FLOPS
    memory = bytes_accessed / HBM_BW
    collective = coll_bytes / ICI_BW
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    bound = max(compute, memory, collective)
    frac = compute / bound if bound > 0 else 0.0
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant,
            "roofline_fraction": frac}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D (training) or 2·N_active·D (fwd),
    N_active = active params (MoE: top_k of E experts; decode: per
    generated token), PLUS the analytic attention-matmul term
    (2·2·L_attn·H·hd·S²·B·½ fwd; ×3 train) — 6ND alone badly
    understates attention-heavy small-d models at long S."""
    from repro_torch.models.blocks import layer_kinds, n_groups

    d = cfg.d_model
    act = 0
    emb = cfg.vocab * d
    kinds = layer_kinds(cfg)
    per_layer = []
    for (mixer, ffn) in kinds:
        n = 0
        if mixer == "attn":
            hd = cfg.hd()
            n += d * cfg.n_heads * hd * 2          # wq, wo
            n += d * cfg.n_kv_heads * hd * 2       # wk, wv
        else:
            d_in = cfg.d_inner()
            nst = cfg.ssm_state
            n += d * (2 * d_in + 2 * nst + cfg.ssm_nheads())
            n += d_in * d
        mats = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
        if ffn == "moe":
            n += cfg.top_k * mats * d * cfg.d_ff
        elif ffn == "mlp":
            n += mats * d * cfg.d_ff
        per_layer.append(n)
    act = sum(per_layer) * n_groups(cfg)
    if cfg.family == "encdec":
        hd = cfg.hd()
        enc = cfg.n_enc_layers * (d * cfg.n_heads * hd * 2
                                  + d * cfg.n_kv_heads * hd * 2
                                  + 2 * d * cfg.d_ff)
        # decoder cross-attention params
        act += enc + cfg.n_layers * (d * cfg.n_heads * hd * 2
                                     + d * cfg.n_kv_heads * hd * 2)
    n_active = act + emb  # unembed ~ emb (tied or not: one matmul)

    # analytic attention matmul flops (QK^T + PV), causal halved,
    # sliding window capped
    n_attn_layers = sum(1 for (m, _) in kinds if m == "attn") \
        * n_groups(cfg)
    if cfg.family == "encdec":
        n_attn_layers = cfg.n_layers + cfg.n_enc_layers  # + cross below
    s = shape.seq_len
    eff = min(s, cfg.window) if cfg.window else s
    hd = cfg.hd() if cfg.n_heads else 0
    attn_fwd_per_seq = (2.0 * 2 * n_attn_layers * cfg.n_heads * hd
                        * s * eff * 0.5)
    if cfg.family == "encdec":
        attn_fwd_per_seq += (2.0 * 2 * cfg.n_layers * cfg.n_heads * hd
                             * s * cfg.enc_seq)

    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return (6.0 * n_active * tokens
                + 3.0 * attn_fwd_per_seq * shape.global_batch)
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return (2.0 * n_active * tokens
                + attn_fwd_per_seq * shape.global_batch)
    # decode: per token — attention reads S keys once
    attn_dec = 2.0 * 2 * n_attn_layers * cfg.n_heads * hd * eff
    return (2.0 * n_active + attn_dec) * shape.global_batch
