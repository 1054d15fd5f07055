"""AdamW from scratch: float32 master weights and moments.

The reference's optimizer, leaf for leaf: clipping by the global norm,
bias correction in float32, decoupled weight decay on every leaf (norms
and biases included), and the new weights cast back to each
parameter's type (round to nearest even).  The step counter is an int32
tensor on the parameters' device and the learning rate is computed there
in float32, so an update never waits on the host.  Optimizer state
shards like the parameters (``opt_logical_axes``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import global_norm, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # "cosine" | "linear" | "const"
    keep_master: bool = True  # fp32 master copy when params are bf16


def lr_at(oc: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) as a float32
    scalar tensor, computed in float32 as the reference's traced step."""
    step = (step.to(torch.float32) if isinstance(step, torch.Tensor)
            else torch.tensor(step, dtype=torch.float32))
    warm = torch.clamp((step + 1) / max(1, oc.warmup_steps), max=1.0)
    t = torch.clamp((step - oc.warmup_steps)
                    / max(1, oc.total_steps - oc.warmup_steps), 0.0, 1.0)
    if oc.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * t))
    elif oc.schedule == "linear":
        decay = 1.0 - t
    else:
        decay = 1.0
    return oc.lr * warm * decay


def adamw_init(params, oc: OptConfig) -> dict:
    """``{"step", "mu", "nu"}`` (+ ``"master"`` with ``keep_master``): a
    zero int32 step on the parameters' device, float32 zero moments, and
    a float32 copy of every parameter (a copy even of a float32 one).
    The moments and the master are placed as their parameters (DTensor
    parameters give DTensor state); the step is a plain scalar."""
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "mu": tree_map(zeros, params),
             "nu": tree_map(zeros, params)}
    if oc.keep_master:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def adamw_update(params, grads, state, oc: OptConfig):
    """Returns (new_params, new_state, metrics); the inputs are left as
    they are.  metrics: ``grad_norm`` (before clipping) and ``lr``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(oc.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if oc.grad_clip > 0
             else torch.ones((), dtype=torch.float32, device=gnorm.device))
    lr = lr_at(oc, step)
    b1, b2 = oc.b1, oc.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(p, g, mu, nu, master):
        g = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        mhat = mu / bc1
        nhat = nu / bc2
        base = master if master is not None else p.to(torch.float32)
        new = base - lr * (mhat / (torch.sqrt(nhat) + oc.eps)
                           + oc.weight_decay * base)
        return new.to(p.dtype), mu, nu, new

    masters = state.get("master") or tree_map(lambda _: None, params)
    outs = tree_map(upd, params, grads, state["mu"], state["nu"], masters)
    is_out = lambda x: isinstance(x, tuple) and len(x) == 4 and all(
        isinstance(e, torch.Tensor) for e in x)
    pick = lambda i: tree_map(lambda o: o[i], outs, is_leaf=is_out)
    new_state = {"step": step, "mu": pick(1), "nu": pick(2)}
    if oc.keep_master:
        new_state["master"] = pick(3)
    return pick(0), new_state, {"grad_norm": gnorm, "lr": lr}


def opt_logical_axes(param_axes, oc: OptConfig) -> dict:
    """Optimizer-state logical axes mirroring the params tree."""
    state = {"step": (), "mu": param_axes, "nu": param_axes}
    if oc.keep_master:
        state["master"] = param_axes
    return state


def opt_state_from_jax(cfg: ModelConfig, np_state: dict,
                       device="cuda") -> dict:
    """The reference's AdamW state (numpy arrays: ``step``, and ``mu``,
    ``nu`` and ``master`` shaped as ``init_params``'s tree, superblocks
    stacked) as the port's state on ``device``."""
    dev = resolve_device(device)
    state = {"step": torch.tensor(int(np.asarray(np_state["step"])),
                                  dtype=torch.int32, device=dev)}
    for k in ("mu", "nu", "master"):
        if k in np_state:
            state[k] = lm.params_from_jax(cfg, np_state[k], device=dev)
    return state
