"""Executable non-conv CNN layers (pool / FC helpers).

Convolutions live on the Computing Unit overlay (``overlay.apply_conv``).
All layers here accept a single image ``(H, W, C)`` or a batch
``(B, H, W, C)`` and preserve the input rank; pooling pads SAME windows
with XLA's asymmetric split, as the reference's ``reduce_window`` does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import pad_nhwc, same_pads


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def _pool_window(x: torch.Tensor, k: int, stride: int, padding: str,
                 pad_value: float):
    """(padded NCHW batch, single?) for a k×k window of the given stride."""
    single = x.ndim == 3
    xb = x[None] if single else x
    if padding == "SAME":
        _, pt, pb = same_pads(int(xb.shape[1]), k, stride)
        _, pl, pr = same_pads(int(xb.shape[2]), k, stride)
        xb = pad_nhwc(xb, pt, pb, pl, pr, value=pad_value)
    elif padding != "VALID":
        raise ValueError(f"bad padding {padding!r}; want SAME|VALID")
    return xb.permute(0, 3, 1, 2), single


def _to_nhwc(y: torch.Tensor, single: bool) -> torch.Tensor:
    y = y.permute(0, 2, 3, 1).contiguous()
    return y[0] if single else y


def max_pool(x: torch.Tensor, k: int, stride: int,
             padding: str = "SAME") -> torch.Tensor:
    """Max over k×k windows; SAME pads with −inf (never selected)."""
    xb, single = _pool_window(x, k, stride, padding, float("-inf"))
    return _to_nhwc(F.max_pool2d(xb, k, stride), single)


def avg_pool(x: torch.Tensor, k: int, stride: int,
             padding: str = "SAME") -> torch.Tensor:
    """Mean over the *valid* (unpadded) elements of each k×k window — the
    reference's reduce-window path. The §3.4 overlay form (an average pool
    run as a conv on the GEMM unit) is a later slice of the port."""
    xb, single = _pool_window(x, k, stride, padding, 0.0)
    ones, _ = _pool_window(torch.ones_like(x), k, stride, padding, 0.0)
    s = F.avg_pool2d(xb, k, stride)
    n = F.avg_pool2d(ones, k, stride)
    return _to_nhwc(s / n, single)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(…, H, W, C) → (…, C)."""
    return torch.mean(x, dim=(-3, -2))


def fc(x: torch.Tensor, w: torch.Tensor,
       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fully connected layer over pre-flattened features: x is (f,) or
    (B, f)."""
    y = x @ w
    return y + b if b is not None else y
