"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``rmsnorm``, ``decode_attention``, ``flash_attention``;
sources in ``csrc/``, built and loaded by ``_build``)."""
