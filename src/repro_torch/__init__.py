"""DYNAMAP on PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``repro``: the same planner
(graph IR, cost model, PBQP mapping, lowering), executed by hand-written
CUDA kernels for ``sm_90a`` and served by the same SLO bucket engine.
Public functions keep the reference's layouts (NHWC activations,
``(K1, K2, Cin, Cout)`` weights, ``(O1·O2, K1K2·Cin)`` Toeplitz matrices)
so both packages can be fed the same numpy arrays.
"""
