"""Executable non-conv CNN layers (pool / FC helpers).

Convolutions live on the Computing Unit overlay (``overlay.apply_conv``).
All layers here accept a single image ``(H, W, C)`` or a batch
``(B, H, W, C)`` and preserve the input rank; pooling pads SAME windows
with XLA's asymmetric split, as the reference's ``reduce_window`` does.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.cnn import overlay
from repro_torch.core.algorithms import IM2COL
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
             padding: str = "SAME", *, via: str = "jnp",
             use_pallas: Optional[bool] = None) -> torch.Tensor:
    """§3.4: AvgPool as a K×K conv with 1/(K·K) weights, so it can route
    through the overlay's GEMM unit.

    ``via="overlay"`` runs that form: the channel-diagonal weight streamed
    through ``overlay.apply_conv`` under IM2COL (the im2col kernel, or its
    plain version per ``use_pallas``, like any conv layer); ``via="jnp"``
    (the reference's name) is the reduce-window path. Both divide by the
    number of *valid* (unpadded) window elements, so the two agree."""
    if via == "overlay":
        return _avg_pool_overlay(x, k, stride, padding, use_pallas)
    if via != "jnp":
        raise ValueError(f"unknown avg_pool via {via!r}")
    xb, single = _pool_window(x, k, stride, padding, 0.0)
    ones, _ = _pool_window(torch.ones_like(x), k, stride, padding, 0.0)
    s = F.avg_pool2d(xb, k, stride)
    n = F.avg_pool2d(ones, k, stride)
    return _to_nhwc(s / n, single)


def _avg_pool_overlay(x: torch.Tensor, k: int, stride: int, padding: str,
                      use_pallas: Optional[bool]) -> torch.Tensor:
    """AvgPool on the Computing Unit: a K×K conv, weight (ci == co)/(K·K).

    With SAME padding the GEMM sums zero-padded windows (÷K² everywhere)
    while pooling divides by the valid-element count n, so the output is
    rescaled by K²/n, as the reference does. The weight and the K²/n map
    are built once per shape, dtype and device and kept (a CUDA graph
    that captured this call binds their pointers): never inside a
    capture, since the eager pass before it builds them."""
    c, h, w = int(x.shape[-1]), int(x.shape[-3]), int(x.shape[-2])
    y = overlay.apply_conv(x, _pool_weight(k, c, x.dtype, x.device), IM2COL,
                           stride=stride, padding=padding,
                           use_pallas=use_pallas)
    if padding == "SAME":
        y = y * _pool_rescale(h, w, k, stride, x.dtype, x.device)
    return y


@functools.lru_cache(maxsize=None)
def _pool_weight(k: int, c: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(K, K, C, C) channel-diagonal 1/(K·K) weight."""
    eye = torch.eye(c, dtype=dtype, device=device) / (k * k)
    return eye.expand(k, k, c, c).contiguous()


@functools.lru_cache(maxsize=None)
def _pool_rescale(h: int, w: int, k: int, stride: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """(O1, O2, 1) map of K²/n, n each SAME window's valid elements."""
    def valid(size: int) -> np.ndarray:
        out, before, _ = same_pads(size, k, stride)
        start = np.arange(out) * stride - before
        return np.minimum(start + k, size) - np.maximum(start, 0)

    n = valid(h)[:, None] * valid(w)[None, :]
    return torch.as_tensor((k * k / n)[..., None], dtype=dtype, device=device)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(…, H, W, C) → (…, C): the mean taken in f32 and cast back to
    ``x``'s dtype, as the reference's ``jnp.mean`` widens bf16."""
    return torch.mean(x, dim=(-3, -2), dtype=torch.float32).to(x.dtype)


def fc(x: torch.Tensor, w: torch.Tensor,
       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fully connected layer over pre-flattened features: x is (f,) or
    (B, f). Operands of two dtypes promote, as the reference's ``@``
    does: f32 features with bf16 weights (a gated bf16 model) give f32."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dtype) @ w.to(dtype)
    return y + b if b is not None else y
