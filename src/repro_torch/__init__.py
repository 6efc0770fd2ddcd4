"""Courier on PyTorch and CUDA — the port of the JAX package to an NVIDIA H100.

The paper's Fig. 1 flow (trace → module-database lookup → fusion → balanced
partition → pipeline → off-loaded wrapper) runs on the card through CUDA
kernels written by hand for Hopper, and a pipeline built that way is served
behind a request queue by an asynchronous executor
(``repro_torch.launch.serve``).  Nothing here imports JAX or the JAX
package: ``repro`` stays the reference the port is held against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
