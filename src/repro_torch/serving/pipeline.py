"""Pipeline-parallel microservice serving executors (dense + paged).

Port of ``repro/serving/pipeline.py``: the profile -> place -> execute
loop of the paper's static tier.

  1. ``microservice.partition.decompose`` splits a model into light
     services plus N core stages over contiguous layer ranges; each core
     stage becomes a sub-executor (:class:`_CoreStage`) owning **only**
     its layer range's parameters (``Model.stage_params``: views of the
     stacked tensors, so the stages hold no second copy of a weight) and
     cache slice (``Model.init_cache(layers=)``, or for the paged engine
     the layer range's slice of the block pools,
     ``PagedCache.struct(layers=)``);
  2. activations hand off between stages through a network shim whose
     per-hop latency/bandwidth comes from a ``core.network.EdgeNetwork``
     and a stage -> node placement (:func:`place_stages`: the paper's
     integer program, ``static_ip``, or a baseline);
  3. measured per-stage times (:meth:`_NetShimMixin.profile`: CUDA
     events on the card) feed back into ``partition.to_application``, so
     the placement is derived from the *executed* pipeline.

Stage compute is real and equals the monolithic engines' bit for bit:
the residual stream crosses a stage boundary as the ``(x, delta)`` pair
(``Model.run_stages``), so every norm launch, every kernel body and
every bit of the monolithic forward is kept; the network is simulated
(hop delays are accounted, not slept) and prices one ``(., d_model)``
activation a token, as the reference does.  A decode macro-step and a
verify round are ``Model.decode_steps`` / ``Model.verify_steps`` over
the chain of core stages, the monolithic engines' hot loop itself, with
one host sync; the network accounting stays per device step.  Light services
are accounted at fixed homes: tokenize/detokenize at the entry node,
sample co-located with the exit stage.

Cache layout invariants: every stage's cache slice is indexed by the
same request identity — dense engines by batch slot, paged engines by
the *engine-level* block tables (one :class:`PagedCache` ledger governs
every stage's pools, so block id ``b`` addresses the same logical tokens
in each stage's layer slice).  Admission zeroes the request's SSM state
rows and cross blocks in **every** stage, and copy-on-write pool copies
apply to every stage's pools.  Requests carry no frontend, so cross
layers, and an encoder-decoder's decoder blocks, read their zeroed cross
K/V in every stage, as in the monolithic engines; the ``encoder`` core
service of ``decompose`` is planning-only, as in the reference (no stage
runs it).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import static_placement as sp
from repro_torch.core.network import resource_index
from repro_torch.core.qos import qos_scores
from repro_torch.device import resolve_device
from repro_torch.microservice.partition import (StageSpec, decompose,
                                                profile_stage_ms,
                                                to_application)
from repro_torch.models.kvcache import (PagedCache, paged_copy_blocks,
                                        paged_reset_row)
from repro_torch.models.model import row_views
from repro_torch.models.quantize import bytes_per_param
from repro_torch.models.transformer import MAMBA_KINDS, segment_range
from repro_torch.serving.engine import (_PagedEngine, _SlotEngine, _batch,
                                        _build_model, _to_device,
                                        reset_cache_row)

PLACEMENT_STRATEGIES = ("static_ip", "colocate", "round_robin", "random")


def place_stages(app, net, strategy: str = "static_ip", *, kappa: int = 2,
                 xi: float = sp.XI_DEFAULT, horizon_slots: int = 100,
                 rng: Optional[np.random.Generator] = None,
                 bytes_per_param: Optional[float] = None
                 ) -> Dict[str, int]:
    """Map each core service of ``app`` to a network node.

    ``static_ip`` solves the paper's sparsity-constrained integer
    program (eq. 14, C4–C6) over QoS scores and picks each stage's
    most-instantiated site; the rest are baselines.
    """
    core = app.core_ids
    es = [int(v) for v in np.flatnonzero(net.is_es)]
    es = es or list(range(net.n_nodes))
    if strategy == "static_ip":
        z, q = qos_scores(app, net)
        prob = sp.build_problem(app, net, z, q, kappa=kappa, xi=xi,
                                horizon_slots=horizon_slots,
                                bytes_per_param=bytes_per_param)
        x = sp.solve(prob)
        return {app.ms(m).name: (int(np.argmax(x[m])) if x[m].sum() > 0
                                 else es[0]) for m in core}
    if strategy == "colocate":
        # fattest GPU among ESs — by the named resource column, falling
        # back to total capacity when R is narrower than Table I's
        # [CPU, RAM, GPU, VRAM] layout
        gpu = resource_index("gpu")
        if net.R.shape[1] > gpu:
            score = net.R[es, gpu]
        else:
            score = net.R[es].sum(axis=1)
        v = es[int(np.argmax(score))]
        return {app.ms(m).name: v for m in core}
    if strategy == "round_robin":
        return {app.ms(m).name: es[i % len(es)] for i, m in enumerate(core)}
    if strategy == "random":
        rng = rng if rng is not None else np.random.default_rng(0)
        return {app.ms(m).name: int(rng.choice(es)) for m in core}
    raise ValueError(f"unknown placement strategy {strategy!r}; "
                     f"known: {PLACEMENT_STRATEGIES}")


class _CoreStage:
    """One sub-executor: layers [lo, hi), its parameter views and cache
    slice, and the chunked-prefill / row-reset / copy-on-write hooks.

    With ``paged`` set (the engine's :class:`PagedCache`), the stage's
    caches are its layer slice of the shared block pools and every call
    takes the engine's block-table metadata.  Caches are written in
    place, as the monolithic engines' are.
    """

    def __init__(self, model, params, spec: StageSpec, *, entry: bool,
                 exit_head: bool, max_batch: int, cache_len: int,
                 paged: Optional[PagedCache] = None):
        self.model = model
        self.spec = spec
        self.name = spec.name
        self.lo, self.hi = spec.layer_range
        self.node: int = 0
        self.paged = paged
        self.params = model.stage_params(params, self.lo, self.hi,
                                         entry=entry, exit_head=exit_head)
        # admission discards prompt logits, so prefill skips the head
        self.prefill_params = {k: v for k, v in self.params.items()
                               if k not in ("lm_head", "final_norm")}
        self.segs = segment_range(model.cfg, self.lo, self.hi)
        if paged is None:
            self.caches = model.init_cache(max_batch, cache_len,
                                           layers=(self.lo, self.hi))
        else:
            self.caches = paged.struct(model.dtype,
                                       layers=(self.lo, self.hi))

    def prefill(self, x, pos0: int, row: int, pmeta=None):
        """One request's prefill chunk through this stage: batch row
        ``row`` of the dense caches, or over the pools the request's
        row-sliced tables (``pmeta``) and its SSM state rows."""
        rows = row_views(self.caches, self.segs, row,
                         paged=pmeta is not None)
        return self.model.run_stages(self.prefill_params, x, self.lo,
                                     self.hi, mode="chunk", pos=int(pos0),
                                     caches=rows, paged=pmeta)

    def reset_row(self, row: int, cross_ids=None):
        """Zero this stage's per-request state of row ``row``: every
        dense cache leaf, or the SSM state rows and the cross blocks
        ``cross_ids`` of the pools' engine."""
        if self.paged is None:
            reset_cache_row(self.caches, row)
        else:
            paged_reset_row(self.caches, self.segs, row, cross_ids)

    def copy_blocks(self, src, dst):
        """Copy-on-write pool copies on this stage's slice of the pools."""
        paged_copy_blocks(self.caches, src, dst, has_swa=self.paged.has_swa)

    def scratch_caches(self):
        """Caches a profiling step may write without touching a live
        request: the live KV pools (the profile's tables point at the
        scratch block) or dense caches (whose slot 0, the one a pos-0
        step writes, :meth:`_NetShimMixin.profile` restores), and fresh
        zero state for each Mamba segment."""
        return [{n: torch.zeros_like(a) for n, a in c.items()}
                if seg.kind in MAMBA_KINDS else c
                for seg, c in zip(self.segs, self.caches)]


class _NetShimMixin:
    """Placement, profiling, and simulated-network accounting shared by
    the dense and paged pipelined engines (the profile -> place ->
    execute loop).  Simulated-network stats accumulate in
    :attr:`transfer_ms` / :attr:`transfer_mb` / :attr:`hops` (keyed
    ``(src_node, dst_node)``).
    """

    def _init_stages_and_net(self, cfg, params, *, n_stages, max_batch,
                             cache_len, seed, net,
                             paged: Optional[PagedCache] = None,
                             quantization=None):
        if not 1 <= n_stages <= cfg.n_layers:
            raise ValueError(f"n_stages {n_stages} outside [1, "
                             f"{cfg.n_layers}] for {cfg.name}")
        # the model, its parameters and their projection weights packed
        # once, BEFORE the stages slice them: every stage's views then
        # carry the packed leaves
        _build_model(self, cfg, params, seed, quantization)
        self.batch_width = max_batch
        # stage service sizes reflect the *resident* weight format, so
        # profile -> place -> execute sees the quantized footprint
        self.stage_specs: List[StageSpec] = decompose(
            cfg, n_core_stages=n_stages,
            bytes_per_param=bytes_per_param(self.quantization))
        decoder = [s for s in self.stage_specs
                   if s.kind == "core" and s.name != "encoder"]
        self.stages = [
            _CoreStage(self.model, self.params, spec,
                       entry=(i == 0), exit_head=(i == len(decoder) - 1),
                       max_batch=max_batch, cache_len=cache_len,
                       paged=paged)
            for i, spec in enumerate(decoder)]

        self.net = net
        # tokenize / detokenize run at the first user's access node
        self.entry_node = int(net.user_ed[0]) if net is not None else 0
        self._act_bytes = self.model.dtype.itemsize * cfg.d_model
        self.transfer_ms = 0.0
        self.transfer_mb = 0.0
        self.hops: Dict[tuple, dict] = {}

    # ------------------------------------------------------------------
    # placement / profiling (the profile -> place -> execute loop)
    # ------------------------------------------------------------------
    def set_placement(self, placement: Dict[str, int]):
        """Pin each stage to a node (unnamed stages keep their node)."""
        for st in self.stages:
            if st.name in placement:
                st.node = int(placement[st.name])

    @property
    def placement(self) -> Dict[str, int]:
        return {st.name: st.node for st in self.stages}

    def profile(self, iters: int = 3) -> Dict[str, float]:
        """Measured per-stage decode time (ms) of one device step over
        ``batch_width`` rows at pos 0, via ``partition.profile_stage_ms``
        (CUDA events on the card) — feed to :meth:`to_application`.

        A stage after the first takes a zero ``(x, delta)`` pair, so its
        first norm is the ``add_norm`` it runs when serving.  Profiling
        leaves every live request untouched: paged steps run on tables
        that point every row at the scratch block, dense steps write
        slot 0 of every row, which is saved first and restored after,
        and Mamba segments step fresh zero state."""
        out = {}
        b, d = self.batch_width, self.cfg.d_model
        dev, dtype = self.device, self.model.dtype
        pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        meta, pc = None, self.stages[0].paged
        if pc is not None:  # every row's tables -> the scratch block
            meta = {"tables": torch.zeros(pc.tables.shape,
                                          dtype=torch.int32, device=dev)}
            if pc.has_swa:
                meta["swa_tables"] = torch.zeros(
                    pc.swa_tables.shape, dtype=torch.int32, device=dev)
            if pc.nb_cross:
                meta["cross_tables"] = torch.zeros(
                    pc.cross_tables.shape, dtype=torch.int32, device=dev)
        for i, st in enumerate(self.stages):
            if i == 0:
                x = torch.zeros((b, 1), dtype=torch.int32, device=dev)
            else:
                h = torch.zeros((b, 1, d), dtype=dtype, device=dev)
                x = (h, torch.zeros_like(h))
            caches = st.scratch_caches()
            saved = ([] if meta is not None else
                     [(a, a[:, :, :1].clone()) for c in caches
                      for n, a in c.items() if n in ("k", "v")])
            out[st.name] = profile_stage_ms(
                lambda xx=x, ss=st, cc=caches: self.model.run_stages(
                    ss.params, xx, ss.lo, ss.hi, mode="decode", pos=pos,
                    caches=cc, paged=meta),
                iters=iters)
            for a, slot0 in saved:
                a[:, :, :1] = slot0
        return out

    def to_application(self, rng: np.random.Generator,
                       measured_ms: Optional[Dict[str, float]] = None,
                       **kwargs):
        """Bridge the executed pipeline back to the paper abstraction."""
        return to_application(self.cfg, self.stage_specs, rng,
                              measured_ms=measured_ms, **kwargs)

    # ------------------------------------------------------------------
    # the engine hooks: the monolithic hot loop over the stage chain
    # ------------------------------------------------------------------
    def _chain(self) -> list:
        """The stages as the ``Model`` stage chain: (params, lo, hi,
        caches) each."""
        return [(st.params, st.lo, st.hi, st.caches) for st in self.stages]

    def _meta(self, **kw):
        """The ledger's block-table meta (``PagedCache.meta``), None for
        dense stages."""
        pc = self.stages[0].paged
        return None if pc is None else pc.meta(**kw)

    def _reset_row(self, row: int):
        pc = self.stages[0].paged
        xids = None if pc is None else pc.cross_ids(row)
        for st in self.stages:
            st.reset_row(row, xids)

    def _prefill_row(self, row: int, toks: np.ndarray, pos0: int):
        """One prefill chunk through every stage, its hops accounted."""
        pmeta = self._meta(row=row)
        c = len(toks)
        x = _to_device(toks[None], self.device)
        self._ship(self.entry_node, self.stages[0].node, c * 4 / 1e6)
        for k, st in enumerate(self.stages):
            x = st.prefill(x, pos0, row, pmeta)
            self._ship_between(k, c, self._act_bytes)

    def _forward_steps(self, tokens: np.ndarray, pos: np.ndarray,
                       budgets: np.ndarray, k: int) -> np.ndarray:
        """K greedy decode steps through the stage chain
        (``Model.decode_steps``), the network accounted per device step
        (:meth:`_account_macro`)."""
        toks = self.model.decode_steps(
            self._chain(),
            _batch(tokens, pos, budgets, self.device), self._meta(), k=k)
        self._account_macro(budgets, k)
        # reprolint: disable-next=host-sync -- the ONE deliberate sync
        # per macro-step (counted in n_host_syncs; <= 1/K per token)
        return np.asarray(toks.cpu())

    def _forward_verify(self, tokens: np.ndarray, pos: np.ndarray,
                        budgets: np.ndarray) -> np.ndarray:
        """One draft-verify round through the stage chain
        (``Model.verify_steps``), its hops accounted at once."""
        emit = self.model.verify_steps(
            self._chain(),
            _batch(tokens, pos, budgets, self.device), self._meta())
        self._account_verify(budgets, tokens.shape[1])
        # reprolint: disable-next=host-sync -- the ONE deliberate sync
        # per verify round (counted in n_host_syncs; <= 1 per token)
        return np.asarray(emit.cpu())

    def _account_macro(self, budgets: np.ndarray, k: int):
        """Simulated-network accounting for one macro-step: device step
        i ships for the rows still live at that step (budget > i) — token
        ids entry->stage0, activations between stages, the sampled token
        id back to the entry node for detokenize."""
        for i in range(k):
            n = int((budgets > i).sum())
            if n == 0:
                break
            self._ship(self.entry_node, self.stages[0].node, n * 4 / 1e6)
            for kk in range(len(self.stages)):
                self._ship_between(kk, n, self._act_bytes)
            self._ship(self.stages[-1].node, self.entry_node, n * 4 / 1e6)

    def _account_verify(self, budgets: np.ndarray, s: int):
        """Simulated-network accounting for one verify round: every live
        row ships its whole (K+1)-token chunk at once — draft ids
        entry->stage0, chunk activations between stages, emitted ids
        back for detokenize."""
        n = int((budgets > 0).sum())
        if n == 0:
            return
        self._ship(self.entry_node, self.stages[0].node, n * s * 4 / 1e6)
        for kk in range(len(self.stages)):
            self._ship_between(kk, n * s, self._act_bytes)
        self._ship(self.stages[-1].node, self.entry_node, n * s * 4 / 1e6)

    # ------------------------------------------------------------------
    # network shim
    # ------------------------------------------------------------------
    def _ship(self, src: int, dst: int, mb: float):
        if self.net is None or src == dst or mb <= 0.0:
            return
        ms = self.net.path_ms(src, dst, mb)
        self.transfer_ms += ms
        self.transfer_mb += mb
        agg = self.hops.setdefault((src, dst),
                                   {"count": 0, "mb": 0.0, "ms": 0.0})
        agg["count"] += 1
        agg["mb"] += mb
        agg["ms"] += ms

    def _ship_between(self, k: int, n: int, per_token_bytes: float):
        if k + 1 < len(self.stages):
            self._ship(self.stages[k].node, self.stages[k + 1].node,
                       n * per_token_bytes / 1e6)


class PipelinedEngine(_NetShimMixin, _SlotEngine):
    """Continuous-batching engine whose forward pass is split across
    placed core stages.  API mirrors ``ServingEngine`` (both share the
    ``_SlotEngine`` state machine) plus ``n_stages`` and ``net``; stages
    are placed by :meth:`set_placement`.  Greedy outputs are
    token-identical to it.  ``device`` defaults to ``"cuda"``;
    ``device="cpu"`` runs the kernels' plain versions."""

    def __init__(self, cfg, params=None, *, n_stages: int = 2,
                 max_batch: int = 4, cache_len: int = 128, seed: int = 0,
                 prefill_chunk: int = 16, net=None, decode_steps: int = 1,
                 policy=None, speculative=None, quantization=None,
                 device="cuda"):
        self.device = resolve_device(device)
        super().__init__(cfg, max_batch=max_batch, cache_len=cache_len,
                         prefill_chunk=prefill_chunk,
                         decode_steps=decode_steps, policy=policy,
                         speculative=speculative)
        self._init_stages_and_net(cfg, params, n_stages=n_stages,
                                  max_batch=max_batch, cache_len=cache_len,
                                  seed=seed, net=net,
                                  quantization=quantization)


class PagedPipelinedEngine(_NetShimMixin, _PagedEngine):
    """Paged continuous-batching engine over placed core stages: the
    block-granular scheduler of ``_PagedEngine`` with the stage executor
    and network shim of :class:`PipelinedEngine`.  One engine-level
    :class:`PagedCache` ledger governs every stage's layer-sliced pools,
    so admission, growth, preemption and copy-on-write apply to the
    whole pipeline at once.  Greedy outputs are token-identical to the
    monolithic engines."""

    def __init__(self, cfg, params=None, *, n_stages: int = 2,
                 max_rows: int = 8, max_len: int = 128,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 seed: int = 0, prefill_chunk: int = 16,
                 watermark_blocks: int = 0, net=None, decode_steps: int = 1,
                 policy=None, prefix_sharing: bool = True,
                 speculative=None, quantization=None, device="cuda"):
        self.device = resolve_device(device)
        super().__init__(cfg, max_rows=max_rows, max_len=max_len,
                         block_size=block_size, num_blocks=num_blocks,
                         prefill_chunk=prefill_chunk,
                         watermark_blocks=watermark_blocks,
                         decode_steps=decode_steps, policy=policy,
                         prefix_sharing=prefix_sharing,
                         speculative=speculative, device=self.device)
        self._init_stages_and_net(cfg, params, n_stages=n_stages,
                                  max_batch=max_rows, cache_len=max_len,
                                  seed=seed, net=net, paged=self.pc,
                                  quantization=quantization)

    def _apply_cow(self, pairs):
        src = torch.tensor([s for s, _ in pairs], dtype=torch.long,
                           device=self.device)
        dst = torch.tensor([d for _, d in pairs], dtype=torch.long,
                           device=self.device)
        for st in self.stages:
            st.copy_blocks(src, dst)
