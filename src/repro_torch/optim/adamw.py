"""AdamW as a pure transformation of a tree of tensors.

Counterpart of ``repro/optim/adamw.py``, with its numerics: f32 moments
whatever the params' dtype, the global-norm clip ``min(1, clip / (gnorm
+ 1e-9))``, the bias corrections ``1 - b ** count`` in f32, the update
in f32 cast back to each param's dtype, and the decay mask read from
each leaf's ``keystr`` path (``utils.leaf_paths``).  A tree is a nest of
lists, tuples and dicts of tensors; its leaves are taken in the
reference's order (a list index, then a sorted dict key).  An
``OptState`` is a tree node (``utils.register_node``): its mu, nu and
count sit at ``[<flat index 0>]``, ``[<flat index 1>]`` and ``[<flat
index 2>]`` of a checkpoint's keys, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.utils import (
    leaf_paths,
    register_node,
    tree_map,
    tree_map_with_path,
)

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Optional[Callable[[torch.Tensor], torch.Tensor]] = None  # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    # parameters whose path matches any of these substrings skip decay
    no_decay_tokens: Tuple[str, ...] = ("bias", "norm", "scale", "ln_")


@register_node
@dataclasses.dataclass
class OptState:
    mu: Tree
    nu: Tree
    count: torch.Tensor          # int32, 0-d, on the params' device


def adamw_init(params: Tree) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = leaf_paths(params)[0][1].device
    return OptState(mu=zeros, nu=tree_map(torch.clone, zeros),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared f32 entries, leaf by leaf
    in the reference's order."""
    total = 0
    for _, x in leaf_paths(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _decay_mask(params: Tree, tokens: Tuple[str, ...]) -> Tree:
    return tree_map_with_path(
        lambda path, _: not any(t in path.lower() for t in tokens), params)


@torch.no_grad()
def adamw_update(grads: Tree, state: OptState, params: Tree,
                 cfg: AdamWConfig
                 ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, metrics); nothing is updated in
    place."""
    gnorm = global_norm(grads)
    if cfg.grad_clip_norm is not None:
        scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

    count = state.count + 1
    countf = count.to(torch.float32)
    b1c = 1 - torch.pow(torch.full_like(countf, cfg.b1), countf)
    b2c = 1 - torch.pow(torch.full_like(countf, cfg.b2), countf)
    lr = (cfg.lr(count) if cfg.lr is not None
          else torch.tensor(1e-3, dtype=torch.float32))

    mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g.to(torch.float32),
                  state.mu, grads)
    nu = tree_map(lambda v, g: cfg.b2 * v
                  + (1 - cfg.b2) * torch.square(g.to(torch.float32)),
                  state.nu, grads)

    def upd(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
            dec: bool) -> torch.Tensor:
        pf = p.to(torch.float32)
        step = lr * (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            step = step + lr * cfg.weight_decay * (
                pf if dec else torch.zeros_like(pf))
        return (pf - step).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu,
                          _decay_mask(params, cfg.no_decay_tokens))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, OptState(mu=mu, nu=nu, count=count), metrics
