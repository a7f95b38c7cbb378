"""The paper's 2-layer LSTM LM: parameter definitions, init and loss.

Port of ``src/repro/models/lstm.py``. The JAX layout is kept so the
parameters carry across one to one (``repro_torch.convert``): weights are
``[in, 4H]`` applied as ``x @ W``, the gates split ``i, f, g, o`` and the
forget gate gets ``+1.0`` before its sigmoid. ``nn.LSTM`` (cuDNN) orders
its gates differently and has no forget bias, so it is not used. The
loss is the mean cross-entropy over the ``s-1`` next-token positions.
Large products stay ``torch.matmul``; the input projection of all time
steps is one product ahead of the recurrence.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree

# (shape, init, scale) per parameter, as the reference's ParamDefs
def param_defs(cfg: ModelConfig) -> dict:
    d, h, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    defs: dict = {
        "embed": {"table": ((v, d), "embed", 0.05)},
        "lm_head": ((h, v), "normal", 0.5),
        "lm_bias": ((v,), "zeros", 1.0),
    }
    for i in range(cfg.num_layers):
        in_dim = d if i == 0 else h
        defs[f"lstm_{i}"] = {
            "wx": ((in_dim, 4 * h), "normal", 0.5),
            "wh": ((h, 4 * h), "normal", 0.5),
            "b": ((4 * h,), "zeros", 1.0),
        }
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> dict:
    """Random parameters drawn from ``generator`` in sorted path order:
    N(0, scale^2 / fan_in) (N(0, scale^2) for the embedding), zeros for
    biases. The port's own init; parity tests carry the reference's
    parameters across instead."""
    out = []
    for _, (shape, init, scale) in tree.flatten_with_paths(param_defs(cfg)):
        if init == "zeros":
            out.append(torch.zeros(shape, dtype=cfg.dtype, device=device))
            continue
        std = scale if init == "embed" else scale / max(shape[0], 1) ** 0.5
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * std
        out.append(w.to(cfg.dtype))
    return tree.unflatten(tree.structure(param_defs(cfg)), out)


def _run_layer(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B,S,in] -> [B,S,H], recurrence over time."""
    b, s, _ = x.shape
    hidden = p["wh"].shape[0]
    xw = torch.matmul(x, p["wx"])
    h = x.new_zeros((b, hidden))
    c = torch.zeros((b, hidden), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        z = xw[:, t] + torch.matmul(h, p["wh"]) + p["b"]
        i, f, g, o = torch.split(z.to(torch.float32), hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(x.dtype)
        hs.append(h)
    return torch.stack(hs, dim=1)


def loss(cfg: ModelConfig, params: dict, tokens: torch.Tensor
         ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` [B, S]."""
    tokens = tokens.to(torch.int64)
    x = params["embed"]["table"][tokens]
    for i in range(cfg.num_layers):
        x = _run_layer(params[f"lstm_{i}"], x)
    hs, labels = x[:, :-1], tokens[:, 1:]
    logits = (torch.matmul(hs, params["lm_head"])
              + params["lm_bias"]).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - gold).sum() / max(labels.numel(), 1)
