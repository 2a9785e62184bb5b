"""NVIDIA H100 SXM data-sheet figures (dense rates, no sparsity, at the
700 W power limit), named once: the roofline's terms, the dry run's
memory budget and ``chip_smoke.py``'s kernel bounds read them here."""

PEAK_BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores
PEAK_F32_FLOPS = 67e12          # f32 outside the tensor cores
PEAK_INT8_OPS = 1979e12         # int8 tensor cores
HBM_BYTES = 80e9                # HBM3
HBM_BYTES_PER_S = 3.35e12
# Collective bandwidth per GPU for the roofline's collective term. A
# 16-wide model axis spans two 8-GPU NVLink domains, so its slowest hop
# is InfiniBand NDR, 400 Gb/s = 50 GB/s per GPU (one ConnectX-7 per GPU
# on a DGX H100): the counterpart of the reference's per-link figure.
# Within one node NVLink 4 moves 450 GB/s per GPU each way.
COLLECTIVE_BYTES_PER_S = 50e9
NVLINK_BYTES_PER_S = 450e9
