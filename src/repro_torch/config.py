"""Model configuration for the port (the port's copy of ``repro.config``).

:class:`ModelConfig` keeps every field and ``__post_init__`` check of
the reference, so a config built here describes the same model as its
JAX twin and the two packages can be held against each other field by
field.  :class:`ShapeConfig` and :data:`SHAPES` are the reference's four
assigned input shapes, and ``ModelConfig.supports_shape`` its rule of
which shapes an architecture runs (the dry-run's skip rule).  :func:`reduce_config` shrinks a production config to the CPU
smoke size exactly as the reference does.  Configs are frozen
dataclasses, so they hash.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# Block kinds understood by the reference model (the port runs them all)
BLOCK_KINDS = ("attn", "swa", "cross", "mamba1", "mamba2")
MLP_KINDS = ("dense", "moe", "none")


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description.

    ``block_pattern`` has one entry per decoder layer; encoder layers (for
    enc-dec models) are always full bidirectional attention.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...]
    mlp_kind: str = "dense"

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (0 -> use d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (mamba) ---
    ssm_state: int = 0
    d_inner: int = 0  # 0 -> 2 * d_model
    conv_width: int = 4
    mamba2_headdim: int = 64

    # --- attention details ---
    window: int = 0  # sliding-window size for "swa" blocks
    shared_block_kind: str = ""
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- enc-dec (audio) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0

    # --- VLM ---
    n_image_tokens: int = 0

    # provenance
    source: str = ""

    # dtype of params/activations in the production configs
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.block_pattern) != self.n_layers:
            raise ValueError(f"{self.name}: pattern len "
                             f"{len(self.block_pattern)} != n_layers "
                             f"{self.n_layers}")
        for b in self.block_pattern:
            if b not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {b!r}")
        if self.mlp_kind not in MLP_KINDS:
            raise ValueError(f"unknown mlp kind {self.mlp_kind!r}")

    @property
    def d_inner_eff(self) -> int:
        return self.d_inner if self.d_inner else 2 * self.d_model

    @property
    def moe_d_ff_eff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    @property
    def has_attention(self) -> bool:
        return any(b in ("attn", "swa", "cross") for b in self.block_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if no block requires a full-length KV cache at decode."""
        return all(b in ("mamba1", "mamba2", "swa") for b in self.block_pattern)

    def supports_shape(self, shape: ShapeConfig) -> bool:
        """Decode-shape applicability rules (see DESIGN.md)."""
        if shape.name != "long_500k":
            return True
        # long_500k: SSM / hybrid / windowed archs only.  gemma3's 5:1
        # local:global still qualifies (global layers are linear per decoded
        # token with a seq-sharded cache; local layers are O(window)).
        if self.family in ("ssm", "hybrid"):
            return True
        if self.name.startswith("gemma3") or self.name.startswith("mixtral"):
            return True
        return False

    @property
    def vocab_padded(self) -> int:
        """Embedding rows: the vocab padded up to a multiple of 256,
        as the reference's ``layers.embed_init`` lays the table out."""
        return -(-self.vocab_size // 256) * 256

    # --- parameter counting (what microservice.partition.decompose reads;
    # the reference's counters, term for term)
    def _attn_params(self, kind: str) -> int:
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        p = d * h * hd + 2 * d * kv * hd + h * hd * d  # q, k, v, o
        if self.qkv_bias:
            p += h * hd + 2 * kv * hd
        if kind == "cross":
            p += 2 * d  # extra norms
        return p + 2 * d  # norms

    def _mlp_params(self) -> int:
        if self.mlp_kind == "none":
            return 0
        if self.mlp_kind == "moe":
            ff = self.moe_d_ff_eff
            return (self.n_experts * 3 * self.d_model * ff
                    + self.d_model * self.n_experts)
        return 3 * self.d_model * self.d_ff

    def _mlp_active_params(self) -> int:
        if self.mlp_kind == "none":
            return 0
        if self.mlp_kind == "moe":
            # the top-k experts a token is routed to, and the router
            ff = self.moe_d_ff_eff
            return (self.experts_per_token * 3 * self.d_model * ff
                    + self.d_model * self.n_experts)
        return 3 * self.d_model * self.d_ff

    def _mamba_params(self, kind: str) -> int:
        d, di, ds = self.d_model, self.d_inner_eff, self.ssm_state
        p = d * 2 * di  # in_proj (x, z)
        p += self.conv_width * di  # depthwise conv
        if kind == "mamba1":
            dt_rank = max(1, d // 16)
            p += di * (dt_rank + 2 * ds)  # x_proj -> (dt, B, C)
            p += dt_rank * di  # dt_proj
            p += di * ds  # A_log
        else:  # mamba2 (SSD): per-head A, dt; B,C projected from x
            nh = max(1, di // self.mamba2_headdim)
            p += d * 2 * ds  # B, C proj (state-space ins)
            p += nh * 2  # A_log, dt_bias per head
        p += di  # D skip
        p += di * d  # out_proj
        return p + 2 * d  # norms

    def layer_params(self, kind: str) -> int:
        if kind in ("attn", "swa", "cross"):
            return self._attn_params(kind) + self._mlp_params()
        return self._mamba_params(kind)

    def layer_active_params(self, kind: str) -> int:
        if kind in ("attn", "swa", "cross"):
            return self._attn_params(kind) + self._mlp_active_params()
        return self._mamba_params(kind)

    def _count(self, per_layer) -> int:
        """The embedding, the untied head, the final norm and every
        layer, the weight-shared block's parameters once; for an
        encoder-decoder also the encoder's attn layers (dense MLPs) and
        one cross-attention per decoder layer, counted as the reference
        counts them."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self.d_model  # final norm
        shared = self.shared_block_kind
        kinds = [b for b in self.block_pattern if b != shared]
        kinds += [shared] if shared in self.block_pattern else []
        n += sum(per_layer(b) for b in kinds)
        if self.is_encoder_decoder:
            n += self.n_encoder_layers * (self._attn_params("attn")
                                          + 3 * self.d_model * self.d_ff)
            n += self.n_layers * self._attn_params("cross")
        return n

    def num_params(self) -> int:
        """Every parameter (the reference's ``num_params``, over the
        logical vocab)."""
        return self._count(self.layer_params)

    def num_active_params(self) -> int:
        """The parameters a token runs through (an MoE layer's top-k
        experts only)."""
        return self._count(self.layer_active_params)


def uniform(kind: str, n: int) -> Tuple[str, ...]:
    return tuple([kind] * n)


def every_kth(n: int, base: str, special: str, k: int) -> Tuple[str, ...]:
    """`special` at layers k-1, 2k-1, ... (0-indexed), `base` elsewhere."""
    return tuple(special if (i % k) == (k - 1) else base for i in range(n))


def local_global(n: int, local: int = 5,
                 window_kind: str = "swa") -> Tuple[str, ...]:
    """gemma3-style `local:1 global` repeating pattern."""
    pat = []
    for i in range(n):
        pat.append("attn" if (i % (local + 1)) == local else window_kind)
    return tuple(pat)


def reduce_config(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 128,
                  n_experts: int = 4, vocab: int = 512,
                  seq_cap: int = 64) -> ModelConfig:
    """Shrink a production config to a CPU-smokeable variant of the same
    family (the reference's rules, unchanged).

    Keeps the block-kind mix: the reduced pattern samples one layer of each
    distinct kind present (up to ``n_layers``).
    """
    kinds = []
    for b in cfg.block_pattern:
        if b not in kinds:
            kinds.append(b)
    pattern = tuple((kinds * n_layers)[:n_layers])
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(n_heads, cfg.n_kv_heads))
    while n_heads % n_kv:
        n_kv -= 1
    head_dim = max(16, d_model // n_heads)
    ne = min(n_experts, cfg.n_experts) if cfg.n_experts else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        block_pattern=pattern,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=max(32, d_model * 2),
        moe_d_ff=max(32, d_model) if cfg.mlp_kind == "moe" else 0,
        vocab_size=vocab,
        n_experts=ne,
        experts_per_token=min(cfg.experts_per_token, max(1, ne // 2)) if ne else 0,
        d_inner=2 * d_model if cfg.ssm_state else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        window=min(cfg.window, seq_cap // 2) if cfg.window else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16) if cfg.encoder_seq else 0,
        n_image_tokens=min(cfg.n_image_tokens, 16) if cfg.n_image_tokens else 0,
        dtype="float32",
    )
