"""PyTorch/CUDA port of the serving stack in :mod:`repro`.

The layout mirrors ``src/repro/`` module for module so each port has an
obvious counterpart.  It serves every registered architecture (dense
and windowed attention, Mamba1 / Mamba2, mixtures of experts,
cross-attention and the encoder-decoder) through both monolithic
engines (``serving/engine.py::ServingEngine`` over dense slot caches,
``PagedServingEngine`` over paged pools) and the pipelined ones, with
optional int8 / int4 weight-only quantization (``quantization=``) and
draft-verify speculation; trains the attention decoders; runs the
paper's planning plane and simulation study (``core/``,
``experiments/``, numpy only); and keeps the scheduler testbed and the
dispatch counter (``serving/testbed.py``, ``serving/instrument.py``).
The hand-written Hopper kernels are ``kernels/rmsnorm.py``,
``kernels/decode_attention.py`` (paged and dense),
``kernels/flash_attention.py``, ``kernels/quant_matmul.py`` and
``kernels/selective_scan.py`` (sources under ``csrc/``).

The package imports torch and numpy only.  It shares no code with the
JAX package: whatever host-side logic it needs is its own copy.
Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``, where every
kernel wrapper runs its plain PyTorch version instead.
"""
