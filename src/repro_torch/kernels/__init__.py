"""Kernels written by hand for Hopper (CUDA C++ under ``csrc/``), each with
its plain PyTorch version beside it and a launch count."""
