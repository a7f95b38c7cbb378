"""Decoder-only transformer LM — the chassis of the dense, moe and vlm
families.

Port of ``src/repro/models/transformer.py``, its training path. Every
layer's parameters are stacked on a leading ``layers`` axis, as in the
reference, so the sync sees one leaf per matrix (``layers.ffn.w_gate``
is ``[L, d_model, d_ff]``): the arena slots, each leaf's k, the §5.5
dispatch by real byte size and the checkpoint files all follow that
layout. The forward takes the per-layer views with one ``torch.unbind``
per stacked leaf, so the backward writes each stacked gradient once
(indexing ``leaf[i]`` per layer would write a full-size zero gradient of
the stacked leaf for every layer).

The reference scans the layers with ``lax.scan`` (``cfg.scan_layers``);
eager PyTorch runs them as a Python loop whatever ``scan_layers`` says,
so the flag has no effect here. ``cfg.remat`` wraps each layer in
``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint``. gemma3's per-layer local/global choice, a
``lax.cond`` on the layer code in the reference's scan, is a static
Python dispatch on ``cfg.pattern_codes()``, as the reference's serving
path does it.

The FFN is pluggable, as in the reference: the dense gated MLP
(``common.mlp``) or, for ``family == "moe"``, ``moe.moe_ffn``, whose
load-balance aux loss each layer returns beside its output (inside the
checkpointed body, so its gradient survives remat); ``loss`` adds
``0.01`` times the layers' sum. Left out until serving is ported
(ROADMAP.md): ``init_cache``, ``cache_struct``, ``prefill`` and
``decode_step``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from . import moe as moe_lib
from .attention import attention_block, attn_defs
from .common import (ParamDef, chunked_ce_loss, embed_defs, embed_lookup,
                     mlp, mlp_defs, rms_norm)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"model family {cfg.family!r} on the transformer chassis is not "
            f"ported yet (see ROADMAP.md)")


def _stack(defs: Any, n: int) -> Any:
    """Prepend a 'layers' axis to every ParamDef in a layer's def tree."""
    return tree.tree_map(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.init,
                           d.scale), defs)


def _ffn_defs(cfg: ModelConfig) -> dict:
    return moe_lib.moe_defs(cfg) if cfg.family == "moe" else mlp_defs(cfg)


def _ffn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor
               ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, aux): the MoE FFN's aux loss, or None for the dense MLP (the
    reference's ``0.0``, left out so the dense path runs no extra op)."""
    if cfg.family == "moe":
        return moe_lib.moe_ffn(cfg, p, x)
    return mlp(cfg, p, x), None


def layer_defs(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    return {
        "attn": attn_defs(cfg),
        "ffn": _ffn_defs(cfg),
        "norm_attn": ParamDef((cfg.d_model,), (None,), init="zeros"),
        "norm_ffn": ParamDef((cfg.d_model,), (None,), init="zeros"),
    }


def param_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": embed_defs(cfg),
        "layers": _stack(layer_defs(cfg), cfg.num_layers),
        "final_norm": ParamDef((cfg.d_model,), (None,), init="zeros"),
    }


def _layer(cfg: ModelConfig, p: dict, x: torch.Tensor, code: int, *,
           positions: torch.Tensor, prefix_len: Optional[int]
           ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One transformer layer -> (x, aux); ``code``: 0 = global/full, 1 =
    local/SWA."""
    g_theta = cfg.rope_theta_global or cfg.rope_theta
    if cfg.window_size is None:
        window, theta = None, g_theta
    elif cfg.layer_pattern is None or code == 1:
        window, theta = cfg.window_size, cfg.rope_theta
    else:
        window, theta = None, g_theta
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    x = x + attention_block(cfg, p["attn"], h, positions=positions,
                            theta=theta, window=window,
                            prefix_len=prefix_len,
                            softcap=cfg.attn_logit_softcap)
    h = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    f, aux = _ffn_apply(cfg, p["ffn"], h)
    return x + f, aux


def _run_layers(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                positions: torch.Tensor, prefix_len: Optional[int] = None
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the stacked layers in order (the reference's ``caches is
    None`` path), each under ``checkpoint`` when ``cfg.remat``. Returns
    (x, the layers' aux losses summed in layer order, or None when the
    FFN has none)."""
    leaves, treedef = tree.flatten(params["layers"])
    per_leaf = [torch.unbind(a, 0) for a in leaves]
    codes = cfg.pattern_codes()
    remat = cfg.remat and torch.is_grad_enabled()
    aux = None
    for i in range(cfg.num_layers):
        lp = tree.unflatten(treedef, [v[i] for v in per_leaf])

        def body(x_, lp=lp, code=codes[i]):
            return _layer(cfg, lp, x_, code, positions=positions,
                          prefix_len=prefix_len)
        x, a_i = (checkpoint(body, x, use_reentrant=False) if remat
                  else body(x))
        if a_i is not None:
            aux = a_i if aux is None else aux + a_i
    return x, aux


def hidden_states(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  prefix_embeds: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, Optional[torch.Tensor],
                             Optional[int]]:
    """Train-mode forward -> (hidden [B,S',D], aux or None, prefix_len
    or None)."""
    x = embed_lookup(cfg, params["embed"], tokens)
    prefix_len = None
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        prefix_len = int(prefix_embeds.shape[1])
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_layers(cfg, params, x, positions=positions,
                         prefix_len=prefix_len)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux, prefix_len


def loss(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token CE of ``batch["tokens"]`` [B, S] (after the
    ``prefix_embeds`` prefix, for vlm), weighted by ``loss_mask`` if
    given, plus ``0.01`` times the MoE layers' aux loss. Dense and vlm
    FFNs add none (the reference adds ``0.01 * 0.0``)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    h, aux, prefix_len = hidden_states(cfg, params, tokens,
                                       batch.get("prefix_embeds"))
    if prefix_len is not None:
        h = h[:, prefix_len:]
    ce = chunked_ce_loss(cfg, params["embed"], h[:, :-1], tokens[:, 1:],
                         batch.get("loss_mask"))
    return ce if aux is None else ce + 0.01 * aux
