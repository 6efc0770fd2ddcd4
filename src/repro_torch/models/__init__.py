"""Workloads the port runs: the paper's Harris case study, the model-zoo
transformer, and the LM stack (the dense, moe, hybrid and ssm families)."""
from .config import SHAPES, ArchConfig, ShapeConfig, supports_shape
from .transformer import LM

__all__ = ["LM", "ArchConfig", "ShapeConfig", "SHAPES", "supports_shape"]
