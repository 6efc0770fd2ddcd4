"""hymba-1.5b [hybrid] — parallel attn + mamba heads (arXiv:2411.13676).

Hymba mixes sliding-window attention with a parallel SSM branch per block;
the SSM branch supplies the global context, so SWA everywhere keeps the
arch sub-quadratic (long_500k eligible). See DESIGN.md §5.
"""
from ..models.config import ArchConfig

config = ArchConfig(
    arch_id="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    window=1024, ssm_state=16, hybrid=True,
)
