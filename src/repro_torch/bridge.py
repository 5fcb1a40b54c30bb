"""Weights bridge: JAX parameters (already numpy) → the port's tensors.

The caller converts the JAX ``init_params`` pytree leaf by leaf
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX.  Path names are kept: ``tree["layers"]["attn"]["q"]["w"]`` becomes
``params["layers"]["attn"]["q"]["w"]``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_numpy"]


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
