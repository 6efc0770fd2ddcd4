"""DeepSeek-67B's widths, as the zoo transformer demo reads them.

Source: ``src/repro/configs/deepseek_67b.py:6-7`` (DeepSeek LLM,
arXiv:2401.02954): d_model 8192, 64 heads x 128, d_ff 22016, vocab 102400,
rope_theta 1e4.  ``repro_torch.launch.serve.serve_traced_transformer_demo``
and ``chip_smoke.py`` serve the zoo transformer at these widths.

What the served model computes differently from DeepSeek-67B (the cuts):

* depth: 2 layers of the published 95 (the zoo demo's default);
* attention: the zoo's multi-head attention, so wk and wv are 8192 x 8192;
  DeepSeek-67B has 8 kv heads (GQA), which the JAX package's zoo lacks;
* dtype: float32, as in the demo; random weights from a seed.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ZooWidths:
    """The keyword arguments of ``serve_traced_transformer_demo`` that set
    the model (its rope_theta, 1e4, is the zoo's default)."""

    d: int = 8192               # d_model
    n_heads: int = 64           # x head_dim 128
    ff: int = 22016             # SwiGLU d_ff
    vocab: int = 102400
    n_layers: int = 2           # cut from 95


config = ZooWidths()
