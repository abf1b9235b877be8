"""Plain references of architectures the JAX package does not have, in
float32 PyTorch: no kernels, no cache, no batching, and no import of the rest
of the port or of JAX. The CPU tests hold the port to them."""
