"""Weights bridge: JAX parameters (already numpy) → the port's tensors.

The caller converts the JAX ``init_params`` pytree leaf by leaf
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX.  Path names are kept: ``tree["layers"]["attn"]["q"]["w"]`` becomes
``params["layers"]["attn"]["q"]["w"]``.  A gradient tree has the same
paths, and an optimizer state is two such trees and a step counter.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.optim.adamw import OptState

__all__ = ["params_from_numpy", "grads_from_numpy", "opt_state_from_numpy"]


def params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """Nested dict of numpy arrays → same-shaped dict of tensors on
    ``device`` (dtypes kept)."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device)
        else:
            out[name] = torch.from_numpy(np.array(leaf)).to(device)
    return out


def grads_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """A gradient tree (the parameters' paths) → tensors on ``device``."""
    return params_from_numpy(tree, device)


def opt_state_from_numpy(m: Dict[str, Any], v: Dict[str, Any], step,
                         device) -> OptState:
    """The JAX ``OptState``'s fields as numpy (the ``m`` and ``v`` trees
    and the scalar ``step``) → the port's
    :class:`~repro_torch.optim.adamw.OptState` on ``device``, the step
    an int32 scalar tensor."""
    return OptState(
        m=params_from_numpy(m, device), v=params_from_numpy(v, device),
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device))
