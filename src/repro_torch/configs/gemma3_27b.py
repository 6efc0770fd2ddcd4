"""gemma3-27b [dense] — 5:1 local:global sliding window, 128k context."""
from ..models.config import ArchConfig

config = ArchConfig(
    arch_id="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144,
    window=1024, global_every=6,
    rope_theta=1e4, rope_theta_global=1e6,
)
