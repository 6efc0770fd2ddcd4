"""rwkv6-1.6b [ssm] — Finch, data-dependent decay (arXiv:2404.05892)."""
from ..models.config import ArchConfig

config = ArchConfig(
    arch_id="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65536,
    rwkv=True,
)
