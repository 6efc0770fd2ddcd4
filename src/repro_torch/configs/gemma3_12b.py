"""gemma3-12b [dense] — 5:1 local:global sliding window, 128k context."""
from ..models.config import ArchConfig

config = ArchConfig(
    arch_id="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    window=1024, global_every=6,            # 5 local : 1 global
    rope_theta=1e4, rope_theta_global=1e6,
)
