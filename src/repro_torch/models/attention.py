"""Attention: GQA/MQA, RoPE, qk-norm, sliding-window, prefix-LM, softcap.

Port of ``src/repro/models/attention.py``, its training path: the
projections (``_project_qkv``), the mask (``_mask``), ``flash_attention``
as the reference runs it when differentiated (``differentiable=True``)
and ``attention_block`` without a cache.

``flash_attention`` keeps the reference's static span skipping: query
chunk c attends only to the kv chunks ``[lo_c, hi_c)`` that its causal or
windowed mask can reach, so causal and windowed layers do the true work.
Within the span it takes one softmax over all the span's keys, in f32 as
the reference upcasts, rather than the reference's online loop over kv
chunks; the two agree to f32 rounding (the online loop rescales its
running sums once per kv chunk). Masked scores are ``NEG_INF`` (not
-inf) and the normaliser is guarded by ``max(l, 1e-30)``, as in the
reference, so a query row with no visible key gets the same output.
``scaled_dot_product_attention`` is not used: it takes neither the
prefix-LM mask together with a softcap nor these numerics.

Head layout: q [B,S,Hkv,G,hd] grouped per kv head; k/v [B,S,Hkv,hd].

Left out until serving is ported (ROADMAP.md): ``KVCache``,
``cache_spec``, ``decode_attention``, ``cache_insert``, the
``fill_cache`` branch and the serving prefill's traced query loop
(``differentiable=False``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from .common import ParamDef, rms_norm, rope

NEG_INF = -1e30


def attn_defs(cfg: ModelConfig) -> dict:
    hd, hq, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    d = {
        "wq": ParamDef((cfg.d_model, hq * hd), ("embed", "heads")),
        "wk": ParamDef((cfg.d_model, hkv * hd), ("embed", "kv_heads")),
        "wv": ParamDef((cfg.d_model, hkv * hd), ("embed", "kv_heads")),
        "wo": ParamDef((hq * hd, cfg.d_model), ("heads", "embed")),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((hd,), (None,), init="zeros")
        d["k_norm"] = ParamDef((hd,), (None,), init="zeros")
    return d


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, theta: float):
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rope(q, positions, theta), rope(k, positions, theta), v


def _mask(pos_q, pos_k, *, causal, window, prefix_len, kv_limit):
    """[qc, kc] boolean mask from absolute positions."""
    m = pos_k[None, :] < kv_limit
    if causal:
        c = pos_k[None, :] <= pos_q[:, None]
        if window is not None:
            c = c & (pos_k[None, :] > pos_q[:, None] - window)
        if prefix_len is not None:
            both_prefix = ((pos_q[:, None] < prefix_len)
                           & (pos_k[None, :] < prefix_len))
            c = c | both_prefix
        m = m & c
    return m


def _span(qs: int, qc: int, nk: int, kc: int, skv: int, *, causal: bool,
          window: Optional[int], prefix_len: Optional[int], q_offset: int
          ) -> tuple[int, int]:
    """The kv chunks ``[lo_c, hi_c)`` query chunk ``[qs, qs + qc)`` can
    see: the reference's static bounds (``attention.py:133-143``)."""
    if not causal:
        return 0, nk
    hi = min(q_offset + qs + qc, skv)
    if prefix_len is not None:
        hi = max(hi, int(prefix_len))
    hi_c = min(-(-hi // kc), nk)
    if window is None or prefix_len is not None:
        lo_c = 0
    else:
        lo_c = max(0, (q_offset + qs - window) // kc)
    return lo_c, hi_c


def flash_attention(
    q: torch.Tensor,             # [B, Sq, Hq, hd]
    k: torch.Tensor,             # [B, Skv, Hkv, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: Optional[int] = None,
    q_offset: int = 0,           # absolute position of q[0]
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Chunked attention over static kv spans (see the module docstring).
    Returns [B, Sq, Hq, hd] in q's dtype."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    dev = q.device

    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    nq, nk = -(-sq // qc), -(-skv // kc)
    qg = q.reshape(b, sq, hkv, g, hd)
    outs = []
    for qi in range(nq):
        qs = qi * qc
        q_blk = qg[:, qs:qs + qc].to(torch.float32) * scale
        rows = q_blk.shape[1]          # the last chunk may be short
        lo_c, hi_c = _span(qs, qc, nk, kc, skv, causal=causal,
                           window=window, prefix_len=prefix_len,
                           q_offset=q_offset)
        if hi_c <= lo_c:               # no kv chunk in reach: zeros
            outs.append(q_blk.new_zeros((b, rows, hkv, g, hd)))
            continue
        k0, k1 = lo_c * kc, min(hi_c * kc, skv)
        k_blk = k[:, k0:k1].to(torch.float32)
        v_blk = v[:, k0:k1].to(torch.float32)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        pos_q = q_offset + qs + torch.arange(rows, device=dev)
        pos_k = k0 + torch.arange(k1 - k0, device=dev)
        msk = _mask(pos_q, pos_k, causal=causal, window=window,
                    prefix_len=prefix_len, kv_limit=skv)
        s = torch.where(msk, s, torch.full_like(s, NEG_INF))
        m = torch.amax(s, dim=-1, keepdim=True).detach()
        p = torch.exp(s - m)
        l_ = torch.sum(p, dim=-1)
        acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk)
        out = acc / torch.clamp(l_, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))     # [B, rows, Hkv, G, hd]
    out = torch.cat(outs, dim=1).reshape(b, sq, hq, hd)
    return out.to(q.dtype)


def attention_block(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    theta: float,
    window: Optional[int] = None,
    causal: bool = True,
    prefix_len: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention of the training forward (no cache): [B,S,D] ->
    [B,S,D]."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, theta)
    out = flash_attention(
        q, k, v, causal=causal, window=window, prefix_len=prefix_len,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
        softcap=softcap)
    return out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["wo"]
