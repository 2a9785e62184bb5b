"""Parameters from the JAX reference, carried over as numpy arrays.

The reference's ``repro.cnn.executor.init_params`` returns a pytree
``{nid: {"w": array, "b": array}}``; converted to numpy by the caller
(``jax.tree_util.tree_map(np.asarray, params)``), it becomes the port's
params here without this package ever importing JAX. Layouts are the
same on both sides: conv ``w`` is ``(K1, K2, Cin, Cout)``, FC ``w`` is
``(in, out)``."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


def params_from_jax(np_params: Mapping[int, Mapping[str, np.ndarray]],
                    device="cuda") -> Dict[int, Dict[str, torch.Tensor]]:
    """``{nid: {name: ndarray}}`` → ``{nid: {name: tensor}}`` on
    ``device``, dtype kept."""
    dev = resolve_device(device)
    return {int(nid): {name: torch.tensor(np.asarray(arr), device=dev)
                       for name, arr in layer.items()}
            for nid, layer in np_params.items()}
