"""Calibration and the accuracy gate for the int8 overlay path.

The mapper prices int8 algorithm replicas purely by throughput
(``V5E_INT8``: 2x the MACs, half the bytes); whether a layer can *afford*
int8 numerically is a property of its weights and activations, not its
cost. This module closes that loop before a plan is finalized, as the
reference's ``core/quant.py`` does:

* ``calibrate_act_scales`` — one eager f32 walk over sample inputs,
  recording each conv layer's input abs-max through the executor's
  ``conv_tap`` hook; the per-tensor activation scale is ``amax / 127``
  (symmetric, zero-point 0 — matching ``kernels.common.quantize``).
* ``layer_errors`` — per-layer quantization error measured in isolation:
  each layer runs once at f32 and once through the int8 emulation on its
  OWN f32 reference input (errors never compound across layers), both on
  the vendor convolution (``F.conv2d``, the "lax" backend).
* ``plan_mixed_precision`` — the gate: solve the precision-aware PBQP,
  demote every int8 layer whose isolated error exceeds ``tol`` via
  ``map_network(force_bf16=...)``, and re-solve to a fixpoint.

Everything runs on the device the params live on, in true f32: TF32 is
off for both walks whatever the caller's global flags say, since the
isolated errors sit within a few 1e-3 of ``tol`` and TF32's rounding
would move layers across it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List

import torch

from repro_torch.core.graph import Graph
from repro_torch.core.mapper import ExecutionPlan, HardwareChoice, map_network
from repro_torch.kernels.common import _SCALE_EPS, INT8_MAX

Params = Dict[int, Dict[str, torch.Tensor]]

_MAX_ROUNDS = 8        # PBQP solves before the gate stops demoting


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Disable TF32 for cuDNN convolutions and cuBLAS matmuls, restoring
    the caller's flags on exit."""
    conv, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = conv.allow_tf32, mm.allow_tf32
    conv.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        conv.allow_tf32, mm.allow_tf32 = saved


def _device(params: Params) -> torch.device:
    return next(iter(params.values()))["w"].device


def _capture_conv_inputs(graph: Graph, params: Params, x
                         ) -> Dict[int, torch.Tensor]:
    """One eager f32 walk on the plain path (im2col everywhere, as the
    reference's ``forward(plan=None)``); returns each conv node's NHWC
    input exactly as the executor would feed it (post-pool,
    post-concat)."""
    from repro_torch.cnn.executor import forward  # executor imports core

    captured: Dict[int, torch.Tensor] = {}

    def tap(nid: int, xin: torch.Tensor) -> None:
        captured[nid] = xin

    forward(graph, params, x, plan=None, use_pallas=False, conv_tap=tap,
            device=_device(params))
    return captured


@no_tf32()
def calibrate_act_scales(graph: Graph, params: Params,
                         samples) -> Dict[int, float]:
    """Per-tensor activation scales from sample inputs.

    ``samples``: one image (H, W, C) or a calibration batch (N, H, W, C),
    numpy or tensor. Runs the plain f32 walk (a layer's input does not
    depend on the plan — every plan computes the same function) and
    returns ``{nid: amax / 127}`` for every conv, a Python float each; it
    feeds ``lower_plan(act_scales=...)`` / ``compile_plan``."""
    captured = _capture_conv_inputs(graph, params, samples)
    return {nid: max(float(torch.amax(torch.abs(xin))), _SCALE_EPS)
            / INT8_MAX for nid, xin in captured.items()}


def _median(v: torch.Tensor) -> torch.Tensor:
    """The median of every element, the mean of the two middle ones for an
    even count (as ``jnp.median``; ``torch.median`` takes the lower)."""
    s = torch.sort(v.reshape(-1)).values
    n = s.numel()
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@no_tf32()
def layer_errors(graph: Graph, params: Params, x,
                 act_scales: Dict[int, float]) -> Dict[int, float]:
    """Isolated per-layer int8 output error vs the f32 output.

    For each conv with a calibrated scale, the layer runs on its f32 reference input twice — plain f32
    and through the int8 emulation (quantization error identical to the
    int8 kernels') — both on the "lax" backend, and reports
    ``mean|int8 - f32| / median|f32|``: the robust denominator keeps an
    activation outlier from hiding the layer that most needs demotion.
    Epilogue-free: bias adds a quantization-independent offset and ReLU
    only clips, so the raw conv output is the conservative point."""
    from repro_torch.cnn import overlay              # overlay imports core
    from repro_torch.core.algorithms import IM2COL

    captured = _capture_conv_inputs(graph, params, x)
    errors: Dict[int, float] = {}
    with torch.inference_mode():
        for nid in sorted(n for n in captured if n in act_scales):
            m = graph.nodes[nid].conv
            pad = "SAME" if m.pad == "same" else "VALID"
            xin, w = captured[nid], params[nid]["w"]
            ref = overlay.apply_conv(xin, w, IM2COL, stride=m.stride,
                                     padding=pad, backend="lax")
            got = overlay.apply_conv(xin, w, IM2COL, stride=m.stride,
                                     padding=pad, backend="lax",
                                     precision="int8",
                                     in_scale=act_scales[nid])
            errors[nid] = float(torch.mean(torch.abs(got - ref))
                                / (_median(torch.abs(ref)) + _SCALE_EPS))
    return errors


@dataclasses.dataclass
class QuantReport:
    """Outcome of the mixed-precision gate: the finalized plan plus
    everything needed to compile and audit it."""
    plan: ExecutionPlan
    act_scales: Dict[int, float]       # conv node -> per-tensor input scale
    errors: Dict[int, float]           # isolated error of every measured node
    demoted: List[int]                 # nodes the gate forced back to bf16
    tol: float
    rounds: int                        # PBQP solves until fixpoint

    @property
    def precision_mix(self) -> Dict[str, int]:
        """{"int8": n, "bf16": m} over the plan's conv layers."""
        mix = {"int8": 0, "bf16": 0}
        for prec in self.plan.precisions.values():
            mix[prec] = mix.get(prec, 0) + 1
        return mix


def plan_mixed_precision(graph: Graph, params: Params, samples,
                         *, tol: float, hw: HardwareChoice) -> QuantReport:
    """Solve a precision-aware plan and demote inaccurate layers to bf16.

    Calibrates activation scales on ``samples``, measures every conv's
    isolated int8 error once, then iterates: solve the joint PBQP
    (``map_network(quantize=True, force_bf16=demoted)``), demote any int8
    layer whose error exceeds ``tol``, re-solve. Each round strictly grows
    the demoted set, so it converges within ``_MAX_ROUNDS``. Feed
    ``report.plan`` and ``report.act_scales`` to ``compile_plan``."""
    act_scales = calibrate_act_scales(graph, params, samples)
    errors = layer_errors(graph, params, samples, act_scales)
    demoted: set = set()
    rounds = 0
    while True:
        rounds += 1
        plan = map_network(graph, hw=hw, quantize=True,
                           force_bf16=sorted(demoted))
        offenders = sorted(
            nid for nid, prec in plan.precisions.items()
            if prec == "int8" and errors.get(nid, 0.0) > tol)
        if not offenders or rounds >= _MAX_ROUNDS:
            break
        demoted.update(offenders)
    return QuantReport(plan=plan, act_scales=act_scales, errors=errors,
                       demoted=sorted(demoted), tol=tol, rounds=rounds)
