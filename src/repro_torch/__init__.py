"""PyTorch/CUDA port of the data plane (serving and training), for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports nothing
of it (and never ``jax``) and keeps its own copies of the configs and
parameter metadata it needs. Its layout mirrors ``repro`` module by module.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`); on the CPU every kernel
wrapper runs its plain PyTorch version.
"""
