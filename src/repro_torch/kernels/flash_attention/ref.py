"""Plain PyTorch version of the flash-attention kernel: masked softmax
attention with GQA / causal / sliding window / ``kv_len`` padding (the
JAX package's ``attention_ref``).  The CPU path and the card's oracle."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float = 1.0, kv_len: int | None = None):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D] → [B, Hq, Sq, D].

    Query row i sits at position i and key j at position j; a row that
    sees no key gives 0."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = mask & (kpos < kv_len)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom > 0, denom, 1.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
