"""Workloads the port runs: the paper's Harris case study and the model-zoo
transformer."""
