"""Fused momentum correction + residual accumulation of one leaf (Alg 4
lines 11-19): ``U' = m * U + g``, ``V' = V + U'`` (``+ g`` with
nesterov), every product and sum rounded on its own.

Port of ``src/repro/kernels/residual_update.py``. ``residual_update``
takes three flat f32 tensors of one length (gradient, velocity U,
residual V) and returns fresh (U', V'). For a CPU tensor it runs the
plain twin ``ref.residual_update``; for a CUDA tensor it launches
``residual_update_leaf`` (``csrc/leaf.cu``); anything else raises.
``residual.accumulate`` calls it for every momentum leaf with an f32
residual and no weight decay.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from .common import F, I, L, P, aligned, check_leaf, launches, raise_on, stream


@functools.cache
def _fn():
    from .build import load
    fn = load("leaf").residual_update_launch
    fn.argtypes = [P, P, P, P, P, L, I, F, I, P]
    fn.restype = I
    return fn


def residual_update(grad: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                    momentum: float, nesterov: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(U', V') for flat f32 ``grad``, ``u``, ``v`` of one length."""
    if grad.device.type == "cpu":
        return ref.residual_update(grad, u, v, momentum=momentum,
                                   nesterov=nesterov)
    for a in (grad, u, v):
        check_leaf(a, "residual_update")
    if not grad.shape == u.shape == v.shape:
        raise ValueError(f"residual_update: lengths differ: "
                         f"{tuple(grad.shape)} {tuple(u.shape)} "
                         f"{tuple(v.shape)}")
    u_new, v_new = torch.empty_like(u), torch.empty_like(v)
    rc = _fn()(grad.data_ptr(), u.data_ptr(), v.data_ptr(), u_new.data_ptr(),
               v_new.data_ptr(), grad.numel(),
               aligned(grad, u, v, u_new, v_new), momentum, int(nesterov),
               stream())
    raise_on(rc, "residual_update")
    launches["residual_update"] += 1
    return u_new, v_new
