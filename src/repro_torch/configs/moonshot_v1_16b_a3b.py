"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6."""
from ..models.config import ArchConfig

config = ArchConfig(
    arch_id="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840,
    n_experts=64, top_k=6, rope_theta=5e4,
)
