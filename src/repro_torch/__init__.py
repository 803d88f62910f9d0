"""PyTorch/CUDA port of the serving stack in :mod:`repro`.

The layout mirrors ``src/repro/`` module for module so each port has an
obvious counterpart; what exists so far is the paged-serving main path
of dense attention decoders (``serving/engine.py::PagedServingEngine``)
and the three hand-written Hopper kernels it runs
(``kernels/rmsnorm.py``, ``kernels/decode_attention.py``,
``kernels/flash_attention.py``, sources under ``csrc/``).

The package imports torch and numpy only.  It shares no code with the
JAX package: whatever host-side logic it needs is its own copy.
Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``, where every
kernel wrapper runs its plain PyTorch version instead.
"""
