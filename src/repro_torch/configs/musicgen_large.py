"""musicgen-large [audio] — decoder-only over EnCodec tokens (arXiv:2306.05284).

Backbone only per task spec: the EnCodec frontend is a stub; ``input_specs``
provides precomputed frame embeddings [B, S, d_model].
"""
from ..models.config import ArchConfig

config = ArchConfig(
    arch_id="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048,
    embeds_in=True,
)
