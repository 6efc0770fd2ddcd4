"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer.

Backbone only per task spec: the ViT frontend is a stub; ``input_specs``
provides precomputed image patch embeddings [B, n_img_tokens, d_model].
40 layers = 8 groups of (4 self + 1 cross).
"""
from ..models.config import ArchConfig

config = ArchConfig(
    arch_id="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256,
    cross_attn_every=5, n_img_tokens=1601, rope_theta=5e5,
)
