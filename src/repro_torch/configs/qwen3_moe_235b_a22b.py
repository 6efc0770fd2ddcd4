"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8 (hf:Qwen/Qwen3 family)."""
from ..models.config import ArchConfig

config = ArchConfig(
    arch_id="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    n_experts=128, top_k=8, rope_theta=1e6,
)
