"""PyTorch/CUDA port of the serving stack in :mod:`repro`.

The layout mirrors ``src/repro/`` module for module so each port has an
obvious counterpart; what exists so far is serving of dense attention
decoders and Mamba1 models (``models/ssm.py``) through both monolithic
engines (``serving/engine.py::ServingEngine`` over dense slot caches,
``PagedServingEngine`` over paged pools), with optional int8 / int4
weight-only quantization (``models/quantize.py``, ``quantization=``),
and the hand-written Hopper kernels they run (``kernels/rmsnorm.py``,
``kernels/decode_attention.py`` (paged and dense),
``kernels/flash_attention.py``, ``kernels/quant_matmul.py``,
``kernels/selective_scan.py``; sources under ``csrc/``).

The package imports torch and numpy only.  It shares no code with the
JAX package: whatever host-side logic it needs is its own copy.
Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``, where every
kernel wrapper runs its plain PyTorch version instead.
"""
