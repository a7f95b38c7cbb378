"""Shared model substrate: param definitions, init, norms, RoPE, MLPs,
embeddings, chunked cross-entropy.

Port of ``src/repro/models/common.py``. Parameters are plain nested dicts
of tensors. Structure is declared once as a tree of ``ParamDef`` (shape +
logical axes + initializer), from which ``init_params`` materializes the
tensors.

Left out: ``abstract_params``, ``param_specs``, ``shard``,
``pure_gspmd`` and ``no_activation_constraints``. They describe and
constrain GSPMD sharding over a ``model`` mesh axis; the port shards
nothing (it runs on one device or pure data parallel, every rank holding
the whole tree), so the model code calls no sharding constraint. The
logical ``axes`` stay in ``ParamDef`` for parity with the reference.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree


class ParamDef(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]      # logical axis names, len == ndim
    init: str = "normal"                 # normal | zeros | ones | embed
    scale: float = 1.0                   # stddev multiplier for "normal"


def _path_seed(seed: int, path: str) -> int:
    """The generator seed of one leaf: the reference's ``_path_key`` hash
    of the ``keystr`` path (first 4 bytes of its md5) folded into
    ``seed``. torch draws other numbers than ``jax.random`` from it, so
    the two inits agree in distribution only."""
    h = int.from_bytes(hashlib.md5(path.encode()).digest()[:4], "little")
    return (seed * (1 << 32) + h) % (1 << 63)


def init_params(defs: Any, seed: int, dtype: Any,
                device: str | torch.device = "cpu") -> Any:
    """Materialize a ParamDef tree into tensors on ``device``.

    The reference's rules, copied: ``normal`` draws N(0, (scale /
    sqrt(fan_in))^2) with ``fan_in = shape[0]``, which for a leaf stacked
    on a leading ``layers`` axis is the layer count; ``embed`` draws
    N(0, scale^2); ``zeros`` / ``ones`` are constant. Each leaf draws f32
    from its own generator (``_path_seed``) and is cast to ``dtype``.
    """
    device = torch.device(device)
    out = []
    for path, d in tree.flatten_with_paths(defs):
        if d.init == "zeros":
            out.append(torch.zeros(d.shape, dtype=dtype, device=device))
        elif d.init == "ones":
            out.append(torch.ones(d.shape, dtype=dtype, device=device))
        else:
            fan_in = d.shape[0] if d.shape else 1
            std = d.scale / max(fan_in, 1) ** 0.5
            if d.init == "embed":
                std = d.scale
            gen = torch.Generator(device=device)
            gen.manual_seed(_path_seed(seed, path))
            w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=device)
            out.append(w.mul_(std).to(dtype))
            del w
    return tree.unflatten(tree.structure(defs), out)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] integer."""
    hd = x.shape[-1]
    half = hd // 2
    # the f32 exponent as the reference has it, raised in f64 and rounded
    # once: torch's f32 pow is off by an ulp in a few of these
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = (theta ** expo.to(torch.float64)).to(torch.float32)
    # [..., S, 1, half]: broadcast over the heads dim
    ang = positions.to(torch.float32)[..., :, None, None] * freq
    sin, cos = torch.sin(ang), torch.cos(ang)
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated) + embedding / loss
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig) -> dict:
    return {
        "w_gate": ParamDef((cfg.d_model, cfg.d_ff), ("embed", "ffn")),
        "w_up": ParamDef((cfg.d_model, cfg.d_ff), ("embed", "ffn")),
        "w_down": ParamDef((cfg.d_ff, cfg.d_model), ("ffn", "embed")),
    }


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = act_fn(cfg.act)(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def embed_defs(cfg: ModelConfig) -> dict:
    d = {"table": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"), init="embed", scale=0.02)
    return d


def embed_lookup(cfg: ModelConfig, p: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = F.embedding(tokens.to(torch.int64), p["table"])
    if cfg.embed_scale:
        # sqrt(d) in f32, rounded to the table's dtype before the multiply
        s = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
        x = x * s.to(device=x.device, dtype=x.dtype)
    return x


def lm_logits(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [..., V]."""
    table = p["lm_head"] if "lm_head" in p else p["table"]
    return h @ table.T


def chunked_ce_loss(cfg: ModelConfig, embed_p: dict, hidden: torch.Tensor,
                    labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE without materializing [B,S,V] logits.

    hidden: [B,S,D]; labels: [B,S] (targets aligned with hidden); mask:
    [B,S] f32 weights (None = all ones). Walks the sequence in chunks of
    ``cfg.loss_chunk``; each chunk's f32 logits are recomputed in the
    backward pass (``checkpoint``, the reference's ``jax.checkpoint``), so
    at most one chunk's logits are alive. The sums run in chunk order.
    """
    b, s, _ = hidden.shape
    chunk = min(cfg.loss_chunk, s)
    labels = labels.to(torch.int64)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)

    def body(h_c, l_c, m_c):
        logits = lm_logits(cfg, embed_p, h_c).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, l_c[..., None])[..., 0]
        return torch.sum((lse - gold) * m_c)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        parts = (hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                 mask[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            tot = tot + checkpoint(body, *parts, use_reentrant=False)
        else:
            tot = tot + body(*parts)
        cnt = cnt + torch.sum(parts[2])
    return tot / torch.clamp(cnt, min=1.0)
