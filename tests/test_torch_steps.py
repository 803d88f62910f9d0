"""The port's step factory (``repro_torch.launch.steps.make_step``)
against the reference's (``repro.launch.steps.make_step``).

* Shapes: every leaf of every (arch x supported shape x mesh) step's
  args, both cache layouts at ``decode_32k``, ``REPRO_ZERO1`` off and on:
  the port's local shape and dtype are the reference's
  ``sharding.shard_shape`` and dtype (the reference's side in one
  subprocess an arch, on 512 forced host devices, ``eval_shape`` only).
  The one-layer rule is tests/test_torch_sharding.py's: a block leaf the
  reference stores unstacked has a leading 1 in the port; so the
  argument bytes are equal.
* FLOPs: at the smoke configs on a 1x1 mesh, the port's dry-run FLOPs
  of the train, prefill and decode steps against the matrix products of
  the reference's step fn's jaxpr (tests/_torch_jaxpr.py), less the
  differences named in ``flop_gap`` (each by its cause and amount).
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import torch.distributed as dist  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.filterwarnings("ignore")

_REF_SHAPES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.config import SHAPES
from repro.configs import get_config
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import make_step
from repro.sharding.specs import use_mesh_rules

def norm(path):
    out = []
    for k in path:
        for a in ("key", "name", "idx"):
            if hasattr(k, a):
                out.append(str(getattr(k, a)))
                break
    return "/".join(out)

arch = sys.argv[1]
cfg = get_config(arch)
res = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for name, shape in SHAPES.items():
        if not cfg.supports_shape(shape):
            continue
        runs = [("heads", "")]
        if name == "decode_32k":
            runs.append(("seq", ""))
        if shape.kind == "train":
            runs.append(("heads", "1"))
        for layout, zero1 in runs:
            os.environ["REPRO_ZERO1"] = zero1
            with mesh, use_mesh_rules(mesh):
                _, args = make_step(cfg, shape, mesh, layout)
            leaves = jax.tree_util.tree_flatten_with_path(args)[0]
            res[f"{multi}|{name}|{layout}|{zero1}"] = {
                norm(p): [list(l.sharding.shard_shape(l.shape)), str(l.dtype)]
                for p, l in leaves}
print(json.dumps(res))
"""


def _reference_shapes(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_SHAPES, arch],
                         capture_output=True, text=True, env=env, timeout=300,
                         check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def _flat(tree, prefix="", out=None):
    """path -> leaf of the port's args, paths as the reference's."""
    from repro_torch.training.optimizer import AdamWState
    out = {} if out is None else out
    if isinstance(tree, AdamWState):
        for k in AdamWState._fields:
            _flat(getattr(tree, k), f"{prefix}{k}/", out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}{i}/", out)
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unstacked(cfg, path: str) -> bool:
    """Does the reference store this parameter (or moment) leaf
    unstacked (a one-layer segment's, the shared set's, a one-layer
    encoder's)?  ``path`` is a leaf's path within the params (or a
    moment tree); cache leaves always carry the layer dim."""
    from repro_torch.models.transformer import build_segments
    keys = path.split("/")
    if "shared" in keys:
        return True
    if "segments" not in keys:
        return False
    i = keys.index("segments")
    if "encoder" in keys:
        return cfg.n_encoder_layers <= 1
    seg = build_segments(cfg)[int(keys[i + 1])]
    return seg.length <= 1 or seg.shared


@pytest.fixture(scope="module")
def world():
    from repro_torch.launch import dryrun
    if dist.is_initialized():
        dist.destroy_process_group()
    dryrun.fake_world()
    yield dryrun
    dryrun._MESHES.clear()
    dist.destroy_process_group()


def _arch_ids():
    from repro_torch.configs import ARCH_IDS
    return list(ARCH_IDS)


@pytest.mark.parametrize("arch", _arch_ids())
def test_make_step_local_shapes_equal_reference(world, arch, monkeypatch):
    """Every leaf's local shape and dtype, every cell of ``arch``."""
    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_step
    from repro_torch.sharding.specs import use_mesh_rules
    ref = _reference_shapes(arch)
    cfg = get_config(arch)
    for key, leaves in ref.items():
        multi, name, layout, zero1 = key.split("|")
        monkeypatch.setenv("REPRO_ZERO1", zero1)
        mesh = world.production_mesh(multi == "True")
        with use_mesh_rules(mesh):
            _, args = make_step(cfg, SHAPES[name], mesh, layout)
        port, unstacked = {}, {}
        for i, part in enumerate(args):
            cache = SHAPES[name].kind == "decode" and i == 1
            for p, leaf in _flat(part).items():
                port[f"{i}/{p}"] = leaf
                inner = p.split("/", 1)[1] if p.startswith(("mu/", "nu/")) \
                    else p
                unstacked[f"{i}/{p}"] = not cache and _unstacked(cfg, inner)
        assert set(port) == set(leaves), (key, set(port) ^ set(leaves))
        ref_bytes = port_bytes = 0
        for path, (shape, dtype) in leaves.items():
            local = port[path].to_local()
            want = tuple(shape)
            if unstacked[path]:
                want = (1,) + want
            assert tuple(local.shape) == want, (key, path)
            assert str(local.dtype) == f"torch.{dtype}", (key, path)
            ref_bytes += math.prod(shape) * local.element_size()
            port_bytes += local.numel() * local.element_size()
        assert port_bytes == ref_bytes


# ----------------------------------------------------------------------
# FLOPs against the reference's jaxpr
# ----------------------------------------------------------------------
#: small shapes of each kind (S <= the port's FLASH_Q_BLOCK, one block of
#: the torch-op backward); prefill also past the reference's Q_CHUNK, its
#: blocked extent
FLOP_SHAPES = {"train": (2, 64), "prefill": (2, 64), "prefill_long": (1, 8192),
               "decode": (2, 64)}
FLOP_ARCHS = ("smollm-360m", "mixtral-8x7b", "falcon-mamba-7b",
              "seamless-m4t-medium", "llama-3.2-vision-90b")


def _attention_reads(cfg, b: int, s: int):
    """(B, H, Sq, Sk, hd) of every attention a train step's forward runs:
    each self-attention layer's (the encoder's too), each cross read's
    (a ``cross`` layer's, an encoder-decoder layer's ``enc_xattn``)."""
    from repro_torch.models.transformer import build_segments
    h, hd = cfg.n_heads, cfg.head_dim
    out = []
    for seg in build_segments(cfg):
        for _ in range(seg.length):
            if seg.kind in ("attn", "swa"):
                out.append((b, h, s, s, hd))
                if cfg.is_encoder_decoder:
                    out.append((b, h, s, cfg.encoder_seq, hd))
            elif seg.kind == "cross":
                out.append((b, h, s, cfg.n_image_tokens, hd))
    if cfg.is_encoder_decoder:
        out += [(b, h, cfg.encoder_seq, cfg.encoder_seq, hd)] * (
            cfg.n_encoder_layers)
    return out


def flop_gap(cfg, kind: str, b: int, s: int) -> int:
    """The port's FLOPs less the reference's, by cause (train only; the
    serving steps' products are the same):

    * each attention's gradient (self, cross, the encoder's) recomputes
      its scores ``Q K^T`` (``flash_attention_backward``,
      ``cross_attention_backward``: torch ops over the forward's row
      log-sum-exp or softmax), one product ``2 B H Sq Sk hd`` that
      autodiff of the reference's jnp attention does not run (it keeps
      the probabilities of the rematerialised forward);
    * the scan's gradient is the backward kernel, which records no
      products, where autodiff of the reference's step ``y = einsum(h,
      C)`` runs two a step (dh, dC): ``- 4 B T DI DS`` a Mamba layer."""
    from repro_torch.models.transformer import build_segments
    if kind != "train":
        return 0
    gap = sum(2 * bb * h * sq * sk * hd
              for bb, h, sq, sk, hd in _attention_reads(cfg, b, s))
    mamba = sum(seg.length for seg in build_segments(cfg)
                if seg.kind in ("mamba1", "mamba2"))
    return gap - mamba * 4 * b * s * cfg.d_inner_eff * cfg.ssm_state


def _reference_flops(arch, kind, b, s) -> int:
    from repro.config import ShapeConfig as RefShape
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import make_step as ref_make_step
    from repro.sharding.specs import use_mesh_rules
    from _torch_jaxpr import dot_flops
    mesh = make_host_mesh()
    with mesh, use_mesh_rules(mesh):
        fn, args = ref_make_step(get_smoke_config(arch),
                                 RefShape("t", s, b, kind), mesh)
        return dot_flops(jax.make_jaxpr(fn)(*args))


@pytest.mark.parametrize("kind", sorted(FLOP_SHAPES))
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_dryrun_flops_equal_reference_jaxpr(world, arch, kind,
                                            monkeypatch):
    """The port's 1x1 dry-run FLOPs of a smoke config's step = the
    reference's ``dot_general`` FLOPs of the same step + ``flop_gap``."""
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.delenv("REPRO_ZERO1", raising=False)
    b, s = FLOP_SHAPES[kind]
    kind = kind.split("_")[0]
    cfg = get_smoke_config(arch)
    rec = world.measure(cfg, ShapeConfig("t", s, b, kind),
                        make_host_mesh(world.DEVICE))
    want = _reference_flops(arch, kind, b, s)
    assert rec["flops"] == want + flop_gap(cfg, kind, b, s), (
        rec["flops"], want, flop_gap(cfg, kind, b, s))
