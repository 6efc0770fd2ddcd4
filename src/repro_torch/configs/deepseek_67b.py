"""deepseek-67b [dense] — llama-arch (arXiv:2401.02954).

``config`` is the architecture, as in the JAX package's
``configs/deepseek_67b.py``; ``get_config("deepseek-67b")`` returns it.

``zoo_widths`` are the same widths as the zoo transformer demo reads them
(``repro_torch.launch.serve.serve_traced_transformer_demo`` and
``chip_smoke.py`` serve it at these).  What the served zoo model computes
differently from DeepSeek-67B (the cuts):

* depth: 2 layers of the published 95 (the zoo demo's default);
* attention: the zoo's multi-head attention, so wk and wv are 8192 x 8192;
  DeepSeek-67B has 8 kv heads (GQA), which the JAX package's zoo lacks;
* dtype: float32, as in the demo; random weights from a seed.
"""
from dataclasses import dataclass

from ..models.config import ArchConfig

config = ArchConfig(
    arch_id="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=102400, rope_theta=1e4,
)


@dataclass(frozen=True)
class ZooWidths:
    """The keyword arguments of ``serve_traced_transformer_demo`` that set
    the model (its rope_theta, 1e4, is the zoo's default)."""

    d: int                      # d_model
    n_heads: int                # x head_dim d // n_heads
    ff: int                     # SwiGLU d_ff
    vocab: int
    n_layers: int = 2           # cut from 95


zoo_widths = ZooWidths(d=config.d_model, n_heads=config.n_heads,
                       ff=config.d_ff, vocab=config.vocab)
