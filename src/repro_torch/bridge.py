"""Parameters from the JAX reference, carried over as numpy arrays.

The reference's ``repro.cnn.executor.init_params`` returns a pytree
``{nid: {"w": array, "b": array}}``; converted to numpy by the caller
(``jax.tree_util.tree_map(np.asarray, params)``), it becomes the port's
params here without this package ever importing JAX. Layouts are the
same on both sides: conv ``w`` is ``(K1, K2, Cin, Cout)``, FC ``w`` is
``(in, out)``. The reference's LM parameters (``repro.models.model
.init_model``), a nested dict of arrays, come over the same way through
``lm_params_from_jax``, and its optimizer state (``repro.optim.adamw
.OptState``, its ``m`` and ``v`` trees and its step) through
``opt_state_from_jax``."""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.optim.adamw import OptState


def _tensor(arr, dev: torch.device) -> torch.Tensor:
    """One array as a tensor on ``dev``, dtype kept. A bf16 array (numpy's
    ``ml_dtypes.bfloat16``, which torch cannot read) goes through f32 to
    ``torch.bfloat16``, which is exact."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32),
                            device=dev).to(torch.bfloat16)
    return torch.tensor(arr, device=dev)


def params_from_jax(np_params: Mapping[int, Mapping[str, np.ndarray]],
                    device="cuda") -> Dict[int, Dict[str, torch.Tensor]]:
    """``{nid: {name: ndarray}}`` → ``{nid: {name: tensor}}`` on
    ``device``, dtype kept: the reference's bf16 params
    (``init_params(..., dtype=jnp.bfloat16)``) become ``torch.bfloat16``
    tensors of the same values."""
    dev = resolve_device(device)
    return {int(nid): {name: _tensor(arr, dev)
                       for name, arr in layer.items()}
            for nid, layer in np_params.items()}


def lm_params_from_jax(np_tree: Mapping[str, Any], device="cuda"
                       ) -> Dict[str, Any]:
    """The reference's nested LM param dict of numpy arrays → the same
    nesting of tensors on ``device``, dtype kept (bf16 as
    ``params_from_jax`` takes it)."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node, dev)

    return convert(np_tree)


def opt_state_from_jax(np_opt_state, device="cuda"):
    """The reference's ``OptState(m, v, step)`` of numpy arrays → the
    port's ``optim.adamw.OptState`` on ``device``: ``m`` and ``v`` through
    ``lm_params_from_jax``, ``step`` an int32 scalar."""
    dev = resolve_device(device)
    m, v, step = np_opt_state
    return OptState(m=lm_params_from_jax(m, dev),
                    v=lm_params_from_jax(v, dev),
                    step=torch.tensor(np.asarray(step), dtype=torch.int32,
                                      device=dev))
