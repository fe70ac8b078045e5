"""Carry the reference's weights across: ``from_jax_params`` takes the JAX
parameter tree as NumPy arrays and returns this package's parameters.

The two trees have the same nesting (``embed.embedding``,
``final_ln.scale``, ``stack.{ln1,ln2,attn.{wq,wk,wv,wo,q_norm,k_norm},
mlp.{w_up,w_gate,w_down}}`` stacked ``(L, ...)``; for the moe family
``stack.moe.{router,w_gate,w_up,w_down}`` with an optional
``stack.moe.shared.{w_gate,w_up,w_down}`` in place of ``mlp``, the router
f32 whatever the parameters' type, the experts ``(L, E, d, f)`` and
``(L, E, f, d)``) and the same ``(d_in, d_out)`` weight layout, so nothing
is transposed and the trees compare leaf for leaf; every leaf keeps its
type. This module imports neither JAX nor ml_dtypes: the
caller hands over ``jax.tree.map(np.asarray, params)``, and a bf16 leaf
arrives either as an ``ml_dtypes`` bfloat16 array or viewed as ``uint16``
(pass ``bf16_as_uint16=True`` then). A ``None`` leaf (the hybrid
stack's ``tail`` when the layers divide into whole groups) stays ``None``.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device, bf16_as_uint16: bool) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # an ml_dtypes array: reinterpret
        a, bf16_as_uint16 = a.view(np.uint16), True
    if a.dtype == np.uint16 and bf16_as_uint16:
        bits = torch.from_numpy(a.astype(np.int32)).to(torch.int16)
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)   # own, writable memory


def from_jax_params(tree, device="cuda", bf16_as_uint16: bool = False):
    """tree: nested dict of NumPy arrays (the reference's parameters).
    Returns the same nesting with ``torch.Tensor`` leaves on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device, bf16_as_uint16)
                for k, v in tree.items()}
    return _leaf(tree, device, bf16_as_uint16)
