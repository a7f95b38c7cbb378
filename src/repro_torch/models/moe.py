"""Mixture-of-Experts FFN (grok-1: 8e top-2; granite: 40e top-8).

Port of ``src/repro/models/moe.py``:

  router logits -> top-k expert choice per token -> capacity-bounded slot
  assignment by a per-expert cumulative sum over the flattened
  (token, choice) axis -> pack tokens into [E, C, D] expert buffers ->
  grouped expert FFN (a batched matmul over the E axis) -> combine
  weighted by the renormalised router probabilities.

Capacity ``C = int(T * top_k / E * capacity_factor) + 1``, clamped to
``[top_k, T]``; choices past an expert's capacity are dropped (Switch /
GShard semantics): their combine weight is zero and the residual
connection carries the token through. ``cfg.moe_impl`` picks the packing:
``"onehot"`` (GShard's dispatch and combine einsums over a [T, E, C]
one-hot, O(T*E*C)) or ``"scatter"`` (a scatter into a dump-slotted
[E, C+1, D] buffer and a gather back, O(T*k*D)). Both give the same
routing; outputs differ by f32 rounding only.

Routing matches the reference exactly: top-k by a stable descending
sort (``lax.top_k``'s lowest-index-first order on ties; ``torch.topk``'s
tie order is unspecified), and slot positions by an integer cumulative
sum (the reference's f32 cumsum of the one-hot is exact while
T*k < 2^24, and gives the same integers).

Left out: ``_auto_batch_axes`` and the ``shard_map`` branch of
``moe_ffn``, which keep dispatch capacity per data shard when a serving
mesh is in auto mode. The port shards nothing, and inside the trainer's
data-parallel region the reference takes the local branch too.

Aux loss: the Switch load-balance loss (mean over experts of the top-1
dispatch fraction times the mean router probability, times E), returned
to the caller, which adds it to the task loss with weight 0.01.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .common import ParamDef, act_fn


def moe_defs(cfg: ModelConfig) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": ParamDef((d, e), ("embed", None), scale=0.1),
        "w_gate": ParamDef((e, d, f), ("expert", "embed", "expert_ffn")),
        "w_up": ParamDef((e, d, f), ("expert", "embed", "expert_ffn")),
        "w_down": ParamDef((e, f, d), ("expert", "expert_ffn", "embed")),
    }


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    per = tokens * cfg.num_experts_per_tok / max(cfg.num_experts, 1)
    cap = int(per * cfg.moe_capacity_factor) + 1
    return min(max(cap, cfg.num_experts_per_tok), tokens)


def _route(cfg: ModelConfig, p: dict, xt: torch.Tensor, cap: int):
    """Router + capacity-bounded slot assignment (shared by both impls).

    Returns (gate_vals [T,k], gate_idx [T,k], slot [T,k] i32, keep [T,k],
    sel_onehot [T,k,E] f32, probs [T,E]). Only ``gate_vals`` and
    ``probs`` carry gradients."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = xt.shape[0]
    logits = (xt @ p["router"]).to(torch.float32)              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_idx = torch.sort(probs.detach(), dim=-1, descending=True,
                          stable=True).indices[:, :k]           # [T, k]
    gate_vals = torch.gather(probs, 1, gate_idx)
    # renormalize the chosen gates (mixtral/grok convention)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)

    # position of each (token, choice) within its expert's queue: a
    # cumsum along the flattened (token, choice) axis, laid out as the
    # inner dimension ([E, T*k]; a scan over the outer dimension of
    # [T*k, E] is ~17 ms a layer on an H100 at T*k = 65,536)
    flat_e = gate_idx.reshape(1, t * k)
    sel_t = (torch.arange(e, device=xt.device)[:, None] == flat_e).to(
        torch.int32)                                            # [E, T*k]
    pos_in_expert = torch.cumsum(sel_t, dim=1, dtype=torch.int32) - sel_t
    slot = torch.gather(pos_in_expert, 0, flat_e).reshape(t, k)
    keep = slot < cap
    gate_vals = gate_vals * keep
    sel_onehot = F.one_hot(gate_idx, e).to(torch.float32)      # [T, k, E]
    return gate_vals, gate_idx, slot, keep, sel_onehot, probs


def _expert_ffn(cfg: ModelConfig, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """Grouped expert FFN on packed buffers [E, C, D] -> [E, C, D]."""
    g = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    h = act_fn(cfg.act)(g) * u
    return torch.bmm(h, p["w_down"])                           # [E, C, D]


def _dispatch_onehot(cfg, p, xt, cap, route):
    """GShard-style one-hot matmul dispatch/combine. O(T*E*C) work."""
    gate_vals, _, slot, keep, sel_onehot, _ = route
    # a dropped choice's slot may be past C: its one-hot row is zero
    slot_onehot = F.one_hot(torch.where(keep, slot, 0).long(), cap).to(
        torch.float32) * keep[..., None]
    dispatch = torch.einsum("tke,tkc->tec", sel_onehot, slot_onehot)
    xe = torch.einsum("td,tec->ecd", xt.to(torch.float32), dispatch)
    ye = _expert_ffn(cfg, p, xe.to(xt.dtype))
    combine = torch.einsum("tke,tkc,tk->tec", sel_onehot, slot_onehot,
                           gate_vals.to(torch.float32))         # [T, E, C]
    return torch.einsum("tec,ecd->td", combine, ye.to(torch.float32))


def _dispatch_scatter(cfg, p, xt, cap, route):
    """Scatter/gather dispatch: pack tokens into [E, C, D] (O(T*k*D)),
    un-pack with a gather. Kept (expert, slot) pairs are unique, so each
    kept row is written once; every dropped choice lands in the dump
    slot C, which is sliced away."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t, d = xt.shape
    gate_vals, gate_idx, slot, keep, _, _ = route
    flat_e = gate_idx.reshape(-1)                               # [T*k]
    flat_keep = keep.reshape(-1)
    flat_slot = torch.where(flat_keep, slot.reshape(-1).long(), cap)
    xrep = torch.repeat_interleave(xt.to(torch.float32), k, dim=0)
    xe = torch.zeros((e, cap + 1, d), dtype=torch.float32, device=xt.device)
    xe = xe.index_put((flat_e, flat_slot), xrep, accumulate=True)[:, :cap]
    ye = _expert_ffn(cfg, p, xe.to(xt.dtype))
    yf = ye.to(torch.float32)
    safe = torch.clamp_max(flat_slot, cap - 1)
    picked = yf[flat_e, safe] * flat_keep[:, None]              # [T*k, D]
    return torch.sum(picked.reshape(t, k, d)
                     * gate_vals.to(torch.float32)[..., None], dim=1)


def _moe_local(cfg: ModelConfig, p: dict, xt: torch.Tensor):
    """Dispatch + expert FFN + combine on the local token set."""
    cap = _capacity(xt.shape[0], cfg)
    route = _route(cfg, p, xt, cap)
    if cfg.moe_impl == "scatter":
        out = _dispatch_scatter(cfg, p, xt, cap, route)
    else:
        out = _dispatch_onehot(cfg, p, xt, cap, route)
    # --- load-balance aux loss (Switch) -------------------------------------
    sel_onehot, probs = route[4], route[5]
    frac_tokens = torch.mean(sel_onehot[:, 0], dim=0)          # top-1 dispatch
    mean_prob = torch.mean(probs, dim=0)
    aux = torch.sum(frac_tokens * mean_prob) * cfg.num_experts
    return out, aux


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux load-balance loss scalar f32)."""
    b, s, d = x.shape
    out, aux = _moe_local(cfg, p, x.reshape(b * s, d))
    return out.reshape(b, s, d).to(x.dtype), aux
