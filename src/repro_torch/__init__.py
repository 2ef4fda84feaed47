"""PyTorch/CUDA port of the HBFP system, built slice by slice beside the
JAX reference package `repro`.

This package imports `torch` and never `jax` or anything under `repro`.
The module layout mirrors `repro`'s, so each counterpart is found by name.
Entry points run on the CUDA device unless the caller passes
`device="cpu"` (`repro_torch.device.resolve_device`).
"""
