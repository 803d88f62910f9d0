"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``rmsnorm``, ``decode_attention`` (paged and dense),
``flash_attention``, ``quant_matmul`` (int8 and int4),
``selective_scan``; sources in ``csrc/``, built and loaded by
``_build``), and ``launch_floor``'s empty kernel, the yardstick for
the least time one launch takes."""
