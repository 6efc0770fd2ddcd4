"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407."""
from ..models.config import ArchConfig

config = ArchConfig(
    arch_id="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32768, rope_theta=1e6,
)
