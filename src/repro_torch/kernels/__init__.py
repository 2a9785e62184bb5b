"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``) with
their torch wrappers and plain versions, one subpackage per kernel."""
