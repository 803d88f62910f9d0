"""KV caches and SSM state: dense slot caches, and the paged block
ledger with its torch pools.

Port of ``repro/models/kvcache.py`` for every block kind (``attn``,
``swa``, ``cross``, ``mamba1`` and ``mamba2``).  :func:`cache_struct`
builds the slot engines' dense caches per segment: ``{"k","v"}`` of
``(n_layers, batch, seq_len, kv_heads, hd)`` for attn, ``min(window,
seq_len)`` slots instead of ``seq_len`` for a sliding-window ring,
``{"xk","xv"}`` of ``(n_layers, batch, src, kv_heads, hd)`` for a
``cross`` layer (``src`` = ``n_image_tokens``) and, beside ``k`` / ``v``,
for each attn layer of an encoder-decoder (``src`` = ``encoder_seq``),
``{"h","conv"}`` of ``(n_layers, batch, d_inner, d_state)`` f32 (Mamba2:
``(n_layers, batch, n_heads, headdim, d_state)``, the same elements by
head) and ``(n_layers, batch, W-1, d_inner)`` for a Mamba layer; a
weight-shared attn position is a segment of its own, with its own cache.
The host-side ledger :class:`PagedCache` is the reference's attn, swa and
cross groups (free lists, the attn group's refcounts and copy-on-write
prefix index, ``check()``, and the versioned ``meta()`` snapshot, which
here returns int32 tensors on the ledger's device).
:meth:`PagedCache.struct` builds torch pools ``(n_layers, num_blocks + 1,
block_size, kv_heads, hd)`` per attn segment, ``(n_layers, max_rows *
nb_swa + 1, block_size, kv_heads, hd)`` per ring segment, cross pools
``xk`` / ``xv`` of ``(n_layers, max_rows * nb_cross + 1, block_size,
kv_heads, hd)`` per cross segment (and beside each attn segment's pools
for an encoder-decoder), read in place by the kernels, and ``max_rows``
state rows per Mamba segment.

Caches and pools are **updated in place** — by the model's KV and
state writes, by :func:`paged_copy_blocks`, :func:`paged_reset_row` and
the slot engine's row reset — which replaces the reference's functional
updates under buffer donation.

Cache layout invariants (as in the reference):

* physical block 0 of every paged pool is the **scratch block**: never
  allocated, it absorbs the writes of inactive decode rows; block-table
  entries of unallocated logical blocks point at scratch, and every
  read through them is masked by position;
* stale attn/swa KV needs no zeroing on block reuse — attention masks
  slots above ``pos`` (and ring slots not yet written by the request);
* cross KV (``xk`` / ``xv``) is *not* position-masked, so a request's
  cross blocks (dense: its row) are zeroed at admission (token requests
  carry no frontend; only ``Model.prefill`` writes real cross K/V);
  SSM state rows carry no position, so a row is zeroed when a request
  is admitted to it (:func:`paged_reset_row`);
* attn-pool blocks may be **shared** between requests under
  copy-on-write prefix sharing: a block's content is a pure function of
  the token-id prefix it caches, a per-block refcount tracks its owners,
  and any write to a block with refcount > 1 first copies it.  Sharing
  is gated off for SSM models, sliding-window rings and cross-attention,
  whose per-request state a skipped prefill would not rebuild.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import (MAMBA_KINDS, build_segments,
                                            check_supported, segment_range)


def cross_source(cfg) -> int:
    """Source slots of a ``cross`` layer's K/V: the image patches, or the
    encoder's frames (0 for a model with no cross-attention)."""
    if "cross" in cfg.block_pattern or cfg.is_encoder_decoder:
        return cfg.n_image_tokens or cfg.encoder_seq
    return 0


def _leaves(cfg, seg, rows: int, seq_len: int, dtype) -> dict:
    """One segment's dense cache leaves for ``rows`` rows: name ->
    (shape, dtype).  A Mamba layer's ``h`` is float32 whatever the
    model dtype (Mamba2's by head: ``(nh, headdim, d_state)``); a
    sliding-window ring keeps ``min(window, seq_len)`` slots; cross K/V
    ``xk`` / ``xv`` keep the source's slots (a ``cross`` layer's alone,
    an encoder-decoder's attn layer's beside its ``k`` / ``v``)."""
    head = (cfg.n_kv_heads, cfg.head_dim)
    if seg.kind == "cross":
        shape = (seg.length, rows, cross_source(cfg), *head)
        return {"xk": (shape, dtype), "xv": (shape, dtype)}
    if seg.kind in MAMBA_KINDS:
        di, ds = cfg.d_inner_eff, cfg.ssm_state
        state = ((di, ds) if seg.kind == "mamba1" else
                 (di // cfg.mamba2_headdim, cfg.mamba2_headdim, ds))
        return {"h": ((seg.length, rows, *state), torch.float32),
                "conv": ((seg.length, rows, cfg.conv_width - 1, di), dtype)}
    if seg.kind == "swa" and cfg.window:
        seq_len = min(cfg.window, seq_len)
    shape = (seg.length, rows, seq_len, *head)
    out = {"k": (shape, dtype), "v": (shape, dtype)}
    if cfg.is_encoder_decoder:
        shape = (seg.length, rows, cfg.encoder_seq, *head)
        out.update(xk=(shape, dtype), xv=(shape, dtype))
    return out


def _segments(cfg, layers) -> list:
    """The segments of decoder layers ``layers`` = (lo, hi), all of them
    for None."""
    return (build_segments(cfg) if layers is None
            else segment_range(cfg, *layers))


def cache_struct(cfg, batch: int, seq_len: int, dtype, device="cuda",
                 layers=None) -> list:
    """Dense slot caches, one dict per segment (the reference's
    ``cache_struct``): ``{"k","v"}`` leaves ``(n_layers, batch,
    seq_len, kv_heads, hd)`` for attn (``min(window, seq_len)`` slots
    for a ring), ``{"xk","xv"}`` of the source's slots for cross K/V
    (:func:`_leaves`), ``{"h","conv"}`` for Mamba (``h`` in float32),
    zero-filled on ``device``.  ``layers=(lo, hi)`` restricts them to
    that decoder layer range (a pipeline stage's slice, aligned with
    ``transformer.segment_range``).  The model writes them in place."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [{name: torch.zeros(shape, dtype=dt, device=dev)
             for name, (shape, dt)
             in _leaves(cfg, seg, batch, seq_len, dtype).items()}
            for seg in _segments(cfg, layers)]


def cache_bytes(cfg, batch: int, seq_len: int, bytes_per_el: int = 2) -> int:
    """Bytes of :func:`cache_struct` at ``bytes_per_el`` per element
    (every leaf alike, as the reference counts), computed from the
    shapes (nothing is allocated)."""
    check_supported(cfg)
    return sum(int(np.prod(shape)) * bytes_per_el
               for seg in build_segments(cfg)
               for shape, _ in _leaves(cfg, seg, batch, seq_len,
                                       None).values())


class PagedCache:
    """Host-side paged-cache ledger: free lists + per-request block tables.

    The attn pool is the shared contention pool — ``num_blocks`` usable
    blocks of ``block_size`` tokens; one block id covers the same
    logical token range in *every* layer's pool.  Logical slot ==
    absolute position; a request holds ``ceil(tokens / block_size)``
    blocks and grows block-by-block as it decodes (:meth:`ensure`).
    Token-level admission and preemption arbitrate over this pool.

    **The sliding-window ring** (configs with windowed ``swa`` layers,
    :attr:`has_swa`).  Each request also holds its whole ring from
    admission to release: ``nb_swa = ceil(window_eff / block_size)``
    blocks of a separate ``swa`` group (``max_rows * nb_swa`` blocks,
    its own LIFO free list and its own scratch block 0), mapped by
    :attr:`swa_tables` ``(max_rows, nb_swa)``; ``window_eff = min(window,
    max_len)`` is the ring's size.  Ring blocks are never shared and
    never grow.

    **Cross K/V** (configs with ``cross`` layers or an encoder,
    :attr:`cross_src` source slots).  Each request holds ``nb_cross =
    ceil(cross_src / block_size)`` blocks of a ``cross`` group
    (``max_rows * nb_cross`` blocks, its own free list and scratch block
    0) from admission to release, mapped by :attr:`cross_tables`
    ``(max_rows, nb_cross)``, allocated all-or-nothing with the rest of
    an admission and zeroed by the engine then (cross reads are not
    position-masked).  Never shared, never grown.

    The ledger is pure numpy/python — deterministic LIFO free lists,
    no device state.  Pool tensors are built separately by
    :meth:`struct`; :meth:`meta` uploads the tables to ``device``.

    ``watermark_blocks`` holds back free blocks at admission time: a new
    request is admitted only if its prompt fits *and* the pool stays
    above the watermark, reserving headroom for the decode growth of
    already-running requests (fewer preemptions at high load).

    **Prefix sharing** (``share_prefixes=True``, SERVING.md §Prefix
    sharing).  Blocks become *shared* resources under a per-block
    refcount: a host-side prefix index maps the token ids of every
    fully-prefilled block (keyed by the request's whole token prefix up
    to and including that block, so a match is exact by construction —
    attention KV at position ``p`` is a pure function of tokens
    ``[0, p]``) to the physical block caching it.  :meth:`admit` with
    ``tokens=`` matches the longest indexed full-block prefix and maps
    those blocks into the new request's table with a refcount bump
    instead of allocating + re-prefilling them; :meth:`release` (and
    preemption, which uses the same path) decrements refcounts, and a
    block returns to the free list only at refcount zero.  A write into
    a block with refcount > 1 (:meth:`ensure`) triggers
    **copy-on-write**: a fresh block replaces it in the writer's table
    and the pending device-side pool copy is queued in
    :attr:`pending_copies` for the engine to apply before its next
    forward.
    """

    def __init__(self, cfg, *, max_rows: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 watermark_blocks: int = 0, share_prefixes: bool = False,
                 device="cuda"):
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} is not a multiple of "
                             f"block_size {block_size}")
        check_supported(cfg)
        self.cfg = cfg
        self.device = device
        self.max_rows = max_rows
        self.max_len = max_len
        self.block_size = block_size
        self.nb_logical = max_len // block_size
        self.watermark_blocks = watermark_blocks
        kinds = {seg.kind for seg in build_segments(cfg)}
        self.has_swa = "swa" in kinds and bool(cfg.window)
        self.window_eff = min(cfg.window, max_len) if self.has_swa else 0
        self.nb_swa = (-(-self.window_eff // block_size)
                       if self.has_swa else 0)
        self.cross_src = cross_source(cfg)
        self.nb_cross = -(-self.cross_src // block_size)
        self.num_blocks = (max_rows * self.nb_logical
                           if num_blocks is None else num_blocks)
        self._groups = {"attn": self.num_blocks,
                        "swa": max_rows * self.nb_swa,
                        "cross": max_rows * self.nb_cross}
        # prefix sharing: only the attn pool is content-addressed (SSM
        # state, the SWA ring and cross K/V are per-request state a
        # skipped prefill would not rebuild)
        self.sharing_supported = not (self.has_swa or self.nb_cross
                                      or kinds & set(MAMBA_KINDS))
        self.share_prefixes = bool(share_prefixes) and self.sharing_supported
        # per-block owner count; a block is free iff refcount 0
        self._ref = np.zeros(self.num_blocks + 1, np.int32)
        # token-prefix bytes -> physical block caching that full block,
        # plus the reverse map for de-indexing at refcount zero
        self._prefix_index: Dict[bytes, int] = {}
        self._block_key: Dict[int, bytes] = {}
        # COW pool copies (src, dst) awaiting device application —
        # engines drain via take_pending_copies() before each forward
        self.pending_copies: List[Tuple[int, int]] = []
        self._hit_tokens_row = np.zeros(max_rows, np.int32)
        self.n_prefix_hits = 0      # admissions that matched >= 1 block
        self.prefix_tokens_hit = 0  # prefill tokens skipped, cumulative
        self.blocks_saved = 0       # allocations avoided by sharing
        self.n_cow_copies = 0
        # LIFO free lists; block id 0 is the scratch block of each group
        self._free = {g: list(range(n, 0, -1))
                      for g, n in self._groups.items()}
        self._held = {g: [[] for _ in range(max_rows)]
                      for g in self._groups}
        self.tables = np.zeros((max_rows, self.nb_logical), np.int32)
        self.swa_tables = np.zeros((max_rows, max(self.nb_swa, 1)), np.int32)
        self.cross_tables = np.zeros((max_rows, max(self.nb_cross, 1)),
                                     np.int32)
        # incremental device snapshot: the ledger version bumps on every
        # table mutation (admit/growth/release/preempt); meta() re-uploads
        # only when the version moved, so steady-state decode reuses one
        # immutable device copy instead of copying every table per forward
        self._version = 0
        self._meta_version = -1
        self._meta_cache: Optional[dict] = None
        self.n_meta_uploads = 0

    # -------------------------------------------------------------- pools
    def struct(self, dtype, device=None, layers=None) -> list:
        """Block pools and state rows, one dict per segment of decoder
        layers ``layers`` = (lo, hi) (all of them by default: a pipeline
        stage builds its slice; one ledger governs every slice, so block
        id ``b`` holds the same tokens in each).

        Mirrors the reference's ``struct`` segment-for-segment: attn
        leaves ``{"k","v"}`` are ``(n_layers, num_blocks + 1,
        block_size, kv_heads, hd)`` pools (+1 for the scratch block),
        ring leaves the same with ``max_rows * nb_swa + 1`` blocks, cross
        leaves ``{"xk","xv"}`` with ``max_rows * nb_cross + 1`` (a
        ``cross`` segment's alone, an encoder-decoder's beside each attn
        segment's ``k`` / ``v``),
        Mamba leaves ``{"h","conv"}`` keep ``max_rows`` state rows;
        zero-filled torch tensors, written in place by the model.
        ``device`` defaults to the ledger's own (``"cuda"`` unless
        given).
        """
        cfg = self.cfg
        dev = resolve_device(self.device if device is None else device)
        block = (self.block_size, cfg.n_kv_heads, cfg.head_dim)
        caches = []
        for seg in _segments(cfg, layers):
            if seg.kind in MAMBA_KINDS:
                c = {name: torch.zeros(shape, dtype=dt, device=dev)
                     for name, (shape, dt)
                     in _leaves(cfg, seg, self.max_rows, 0, dtype).items()}
            else:
                c = {}
                if seg.kind != "cross":
                    group = ("swa" if seg.kind == "swa" and cfg.window
                             else "attn")
                    nb = self._groups[group] + 1
                    c = {name: torch.zeros((seg.length, nb, *block),
                                           dtype=dtype, device=dev)
                         for name in ("k", "v")}
                if seg.kind == "cross" or cfg.is_encoder_decoder:
                    nb = self._groups["cross"] + 1
                    c.update({name: torch.zeros((seg.length, nb, *block),
                                                dtype=dtype, device=dev)
                              for name in ("xk", "xv")})
            caches.append(c)
        return caches

    # ---------------------------------------------------------- metadata
    def meta(self, row: Optional[int] = None) -> dict:
        """Block-table metadata for a forward call, as int32 tensors on
        the ledger's device.

        Snapshot copies (the device copy runs asynchronously and the
        ledger must stay mutable on the host side).  ``row`` restricts
        tables to one request (the chunked-prefill path).

        The full-table snapshot (``row=None``, the per-decode path) is
        cached against :attr:`_version`: it is rebuilt only when the
        ledger actually changed since the last upload — during steady-
        state decode the same device tensors are handed to every
        macro-step.  (:attr:`n_meta_uploads` counts rebuilds.)
        """
        if row is None:
            if self._meta_version == self._version:
                return self._meta_cache
            self._meta_cache = self._build_meta(slice(None))
            self._meta_version = self._version
            self.n_meta_uploads += 1
            return self._meta_cache
        return self._build_meta(slice(row, row + 1))

    def _build_meta(self, sel) -> dict:
        out = {"tables": torch.from_numpy(self.tables[sel].copy()).to(
            self.device)}
        if self.has_swa:
            out["swa_tables"] = torch.from_numpy(
                self.swa_tables[sel].copy()).to(self.device)
        if self.nb_cross:
            out["cross_tables"] = torch.from_numpy(
                self.cross_tables[sel].copy()).to(self.device)
        return out

    def cross_ids(self, row: int) -> Optional[torch.Tensor]:
        """Row ``row``'s cross blocks (its cross-table entries) as an int64
        tensor on the ledger's device, the ids :func:`paged_reset_row`
        zeroes at admission; None for a model without cross K/V."""
        if not self.nb_cross:
            return None
        return torch.from_numpy(self.cross_tables[row].astype(np.int64)).to(
            self.device)

    # -------------------------------------------------------- accounting
    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    @property
    def free_blocks(self) -> int:
        return len(self._free["attn"])

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    def utilization(self) -> float:
        return (self.used_blocks / self.num_blocks) if self.num_blocks else 0.0

    def fits(self, total_tokens: int) -> bool:
        """Can a request ever run: worst-case footprint vs pool size."""
        return self.blocks_needed(total_tokens) <= self.num_blocks

    # ---------------------------------------------------- prefix index
    def _prefix_key(self, tokens, logical: int) -> bytes:
        """Index key of logical block ``logical`` for a request whose
        prefilled token ids are ``tokens``: the *whole* prefix through
        that block, so equal keys imply bitwise-equal cached KV."""
        end = (logical + 1) * self.block_size
        return np.asarray(tokens[:end], np.int32).tobytes()

    def _match_blocks(self, tokens) -> List[int]:
        """Longest indexed full-block prefix of ``tokens`` (the
        request's to-be-prefilled ids), as physical block ids.  Only
        blocks *fully covered* by ``tokens`` can match — the block
        holding a request's first decode write is never shared."""
        if not self.share_prefixes or tokens is None:
            return []
        out: List[int] = []
        for j in range(len(tokens) // self.block_size):
            blk = self._prefix_index.get(self._prefix_key(tokens, j))
            if blk is None:
                break
            out.append(blk)
        return out

    def probe_hit(self, tokens) -> int:
        """Blocks an admission with ``tokens`` would share rather than
        allocate — what a capacity-aware admission test subtracts from
        the modeled block demand."""
        return len(self._match_blocks(tokens))

    def hit_tokens(self, row: int) -> int:
        """Prefill tokens row ``row``'s last :meth:`admit` matched (a
        multiple of ``block_size``) — the span the engine skips."""
        return int(self._hit_tokens_row[row])

    def _register_prefixes(self, row: int, tokens) -> None:
        """Index every fully-prefilled block of ``tokens`` that is not
        indexed yet (matched blocks are already present under the same
        keys).  Called at admit time: the row's prefill writes the
        claimed content before any matcher can read it."""
        for j in range(len(tokens) // self.block_size):
            key = self._prefix_key(tokens, j)
            if key not in self._prefix_index:
                blk = int(self.tables[row, j])
                self._prefix_index[key] = blk
                self._block_key[blk] = key

    def _deindex(self, blk: int) -> None:
        key = self._block_key.pop(blk, None)
        if key is not None and self._prefix_index.get(key) == blk:
            del self._prefix_index[key]

    def can_admit(self, n_tokens: int, watermark: Optional[int] = None,
                  tokens=None) -> bool:
        """``watermark`` overrides the configured headroom — the
        scheduler drops it to 0 when nothing is running (headroom only
        exists to protect active requests' decode growth; holding an
        idle pool back would deadlock a lone large request).
        ``tokens`` (the to-be-prefilled ids) lets a prefix hit shrink
        the fresh-block demand."""
        wm = self.watermark_blocks if watermark is None else watermark
        need = self.blocks_needed(n_tokens) - len(self._match_blocks(tokens))
        return (len(self._free["attn"]) - wm >= need
                and len(self._free["swa"]) >= self.nb_swa
                and len(self._free["cross"]) >= self.nb_cross)

    def _alloc(self, group: str, row: int, table: np.ndarray,
               logical: int) -> bool:
        free = self._free[group]
        if not free:
            return False
        blk = free.pop()
        self._held[group][row].append(blk)
        table[row, logical] = blk
        if group == "attn":
            self._ref[blk] = 1
        self._version += 1
        return True

    def _alloc_or_die(self, group: str, row: int, table: np.ndarray,
                      logical: int):
        # callers hold the can_admit guarantee; a failure here is ledger
        # corruption, and must raise even under ``python -O``
        if not self._alloc(group, row, table, logical):
            raise RuntimeError(
                f"{group} pool exhausted mid-admit (row {row}, logical "
                f"{logical}) despite can_admit — ledger corrupted")

    def admit(self, row: int, n_tokens: int,
              watermark: Optional[int] = None, tokens=None) -> bool:
        """Allocate row ``row``'s blocks for logical slots [0, n_tokens)
        plus its full SWA ring and cross blocks.  All-or-nothing.

        With sharing enabled and ``tokens`` (the ids the engine is
        about to prefill, i.e. ``(prompt + out)[:-1]``), the longest
        indexed full-block prefix is *mapped* instead of allocated:
        matched blocks enter the row's table with a refcount bump, and
        :meth:`hit_tokens` reports the span whose prefill the engine
        skips.  Fresh fully-prefilled blocks are registered in the
        prefix index for later arrivals to match."""
        if any(self._held[g][row] for g in self._held):
            raise RuntimeError(f"admit: row {row} still holds blocks")
        matched = self._match_blocks(tokens)
        if not self.can_admit(n_tokens, watermark=watermark,
                              tokens=tokens):
            return False
        for j, blk in enumerate(matched):
            self._ref[blk] += 1
            self._held["attn"][row].append(blk)
            self.tables[row, j] = blk
        if matched:
            self._version += 1
        for j in range(len(matched), self.blocks_needed(n_tokens)):
            self._alloc_or_die("attn", row, self.tables, j)
        for j in range(self.nb_swa):
            self._alloc_or_die("swa", row, self.swa_tables, j)
        for j in range(self.nb_cross):
            self._alloc_or_die("cross", row, self.cross_tables, j)
        if self.share_prefixes and tokens is not None:
            self._register_prefixes(row, tokens)
        hit = len(matched) * self.block_size
        self._hit_tokens_row[row] = hit
        if matched:
            self.n_prefix_hits += 1
            self.prefix_tokens_hit += hit
            self.blocks_saved += len(matched)
        return True

    def _cow(self, row: int, logical: int, src: int) -> bool:
        """Copy-on-write: give ``row`` a private copy of shared block
        ``src`` before it writes into logical slot ``logical``.  The
        device-side pool copy is queued in :attr:`pending_copies`
        (engines apply it before their next forward); the ledger side —
        table entry, held list, refcounts — swaps immediately.  Returns
        False when no free block exists (the scheduler must preempt);
        the shared mapping is left untouched in that case."""
        free = self._free["attn"]
        if not free:
            return False
        dst = free.pop()
        self._ref[dst] = 1
        self._ref[src] -= 1
        held = self._held["attn"][row]
        held[held.index(src)] = dst
        self.tables[row, logical] = dst
        self.pending_copies.append((src, dst))
        self.n_cow_copies += 1
        self._version += 1
        return True

    def ensure(self, row: int, pos: int) -> bool:
        """Grow row ``row`` to cover a *write* at absolute position
        ``pos`` (decode step).  A covered position whose block is
        shared (refcount > 1) triggers copy-on-write; a covered block
        this row owns exclusively but that is still in the prefix index
        is de-indexed (its content is about to diverge from the indexed
        token prefix).  Returns False when the attn pool is exhausted —
        the scheduler must preempt."""
        logical = min(pos, self.max_len - 1) // self.block_size
        held = len(self._held["attn"][row])
        if logical < held:
            blk = int(self.tables[row, logical])
            if self._ref[blk] > 1:
                return self._cow(row, logical, blk)
            if blk in self._block_key:
                self._deindex(blk)
            return True
        if logical != held:  # growth is 1 block/step by construction
            raise RuntimeError(
                f"ensure: row {row} skipped to logical block {logical} "
                f"with only {held} held")
        return self._alloc("attn", row, self.tables, logical)

    def take_pending_copies(self) -> List[Tuple[int, int]]:
        """Drain the queued COW ``(src, dst)`` pool copies.  The caller
        must apply them to every pool leaf (device side) before the next
        forward reads or writes the ``dst`` blocks."""
        out, self.pending_copies = self.pending_copies, []
        return out

    def release(self, row: int):
        """Drop every block reference row ``row`` holds (completion or
        preemption).  Attn blocks are refcounted: a block returns to the
        free list (and leaves the prefix index) only when its last owner
        releases it — a preempted request's shared prefix blocks stay
        resident for their surviving sharers.  The row's ring and cross
        blocks return to their groups' free lists."""
        blocks, free = self._held["attn"][row], self._free["attn"]
        for b in reversed(blocks):  # LIFO order matches the old ledger
            if self._ref[b] <= 0:  # guard must survive ``python -O``
                raise RuntimeError(f"double free of attn block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._deindex(b)
                free.append(b)
        blocks.clear()
        for g in ("swa", "cross"):
            blocks, free = self._held[g][row], self._free[g]
            dup = set(blocks) & set(free)
            if dup:  # guard must survive ``python -O``
                raise RuntimeError(
                    f"double free of {g} blocks {sorted(dup)}")
            free.extend(reversed(blocks))
            blocks.clear()
        self.tables[row] = 0
        self.swa_tables[row] = 0
        self.cross_tables[row] = 0
        self._hit_tokens_row[row] = 0
        self._version += 1

    def check(self):
        """Ledger invariants: every block is exactly one of
        {free, scratch, referenced}; attn refcounts equal both the
        held-list multiplicity and the table occupancy (sharing maps a
        block into several rows' tables, once each); ring and cross
        blocks are held once; no leak, no double-book; index entries
        only on live attn blocks."""
        for g, n in self._groups.items():
            free = self._free[g]
            held = [b for row in self._held[g] for b in row]
            assert len(set(free)) == len(free), f"{g}: dup in free list"
            assert 0 not in free and 0 not in held, f"{g}: scratch booked"
            if g == "attn":
                held_n = Counter(held)
                occupancy = Counter(
                    b for row in range(self.max_rows)
                    for b in self.tables[row].tolist() if b != 0)
                free_set = set(free)
                for b in range(1, n + 1):
                    r = int(self._ref[b])
                    assert r == held_n.get(b, 0), \
                        f"attn: block {b} refcount {r} != held {held_n.get(b, 0)}"
                    assert r == occupancy.get(b, 0), \
                        (f"attn: block {b} refcount {r} != table "
                         f"occupancy {occupancy.get(b, 0)}")
                    assert (b in free_set) == (r == 0), \
                        (f"attn: block {b} ref {r} "
                         f"{'in' if b in free_set else 'not in'} free list")
                assert len(free) + len(set(held)) == n, \
                    f"attn: leak ({len(free)} free + {len(set(held))} held)"
            else:
                assert len(set(held)) == len(held), f"{g}: block shared"
                assert sorted(free + held) == list(range(1, n + 1)), \
                    f"{g}: leak ({len(free)} free + {len(held)} held != {n})"
        for blk, key in self._block_key.items():
            assert self._prefix_index.get(key) == blk, \
                f"index: block {blk} reverse-mapped to a stale key"
            assert self._ref[blk] >= 1, f"index: freed block {blk} indexed"
        assert len(self._prefix_index) == len(self._block_key), \
            "index: forward/reverse maps out of sync"
        for table, g in ((self.tables, "attn"), (self.swa_tables, "swa"),
                         (self.cross_tables, "cross")):
            for row in range(self.max_rows):
                ids = set(table[row].tolist()) - {0}
                assert ids <= set(self._held[g][row]), \
                    f"{g}: row {row} maps unheld blocks"


def paged_reset_row(caches, segs, row: int, cross_ids=None):
    """Zero decode row ``row``'s per-request state in place (the
    reference's ``paged_reset_row``): its SSM state rows, and its cross
    blocks ``cross_ids`` (an int tensor of the row's cross-table
    entries, None for a model without cross K/V) in every ``xk`` /
    ``xv`` pool.  Attn and swa pools are untouched: stale KV is
    position-masked."""
    for seg, c in zip(segs, caches):
        if seg.kind in MAMBA_KINDS:
            for a in c.values():
                a[:, row] = 0
        elif cross_ids is not None:
            for name in ("xk", "xv"):
                if name in c:
                    c[name][:, cross_ids] = 0
    return caches


def paged_copy_blocks(caches, src, dst, *, has_swa: bool = False):
    """Apply queued copy-on-write pool copies in place.

    ``src``/``dst`` are equal-length int tensors of physical pool block
    ids (from :meth:`PagedCache.take_pending_copies`); each dst block
    becomes a copy of its src block across every attn k/v leaf (sharing
    is gated off for SSM models, so their state never needs copying).
    Sharing is gated off for sliding-window models too, whose ring pools
    hold other block ids: ``has_swa`` (the ledger's) asserts that gate
    held."""
    if has_swa:  # guard must survive ``python -O``
        raise RuntimeError("copy-on-write on a sliding-window model "
                           "(sharing is gated off)")
    for c in caches:
        for name in ("k", "v"):
            if name in c:
                a = c[name]
                a[:, dst] = a[:, src]
    return caches
