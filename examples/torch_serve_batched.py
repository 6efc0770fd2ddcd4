"""Batched serving examples on the PyTorch port (the counterpart of
``examples/serve_batched.py``).

LM mode (default): batched prefill (every self-attention through K7 on the
card) and KV-cache greedy decode on a reduced config::

    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

Pipeline mode: the dynamic-batching request-queue server over the Courier
Harris pipeline (bounded-token-pool backpressure, per-request latency
stats)::

    PYTHONPATH=src python examples/torch_serve_batched.py --mode pipeline \\
        --requests 64 --max-batch 8 --device cpu

Without ``--device cpu`` it runs on the card, and refuses to run without
one.
"""
import sys

from repro_torch.launch import serve

if __name__ == "__main__":
    args = sys.argv[1:]
    if "--arch" not in args:
        args = ["--arch", "gemma3-12b"] + args
    if not any(a in ("--reduced", "--no-reduced") for a in args):
        args = args + ["--reduced"]
    serve.main(args)
