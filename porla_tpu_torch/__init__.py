"""porla_tpu_torch — the PyTorch/CUDA port of porla_tpu.

The same dynamic Proof-of-Retrievability protocol as `porla_tpu`, written
with PyTorch tensors and hand-written CUDA kernels for NVIDIA Hopper
(`csrc/`, built with nvcc at first use), and a native host runtime for
AES and batched file IO (`runtime/`, built with g++ at first use). Entry
points take an explicit device: `PorlaServer(cfg, device="cuda")` and
`PorlaClient(cfg, transport, device="cuda")` run on the card and raise
when there is none; `device="cpu"` runs every kernel's plain torch version.
The package imports nothing of JAX or of `porla_tpu`.
"""
