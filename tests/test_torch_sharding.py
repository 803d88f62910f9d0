"""The port's sharding rules, meshes and serving CLI against the JAX
package's (``repro.sharding.specs``, ``repro.launch.mesh``,
``repro.launch.serve``).

Meshes of the production sizes are stood in for by their axis sizes
alone (both packages' rules read only ``shape`` and the axis names), so
the 16x16 and 2x16x16 meshes are reasoned about with no 256 ranks.

The one-layer rule: the port stores every block leaf with a leading
layer dim, a one-layer segment's and zamba2's shared set's (and a
one-layer encoder's) as ``(1, ...)``, where the reference stores them
unstacked.  Such a leaf's port spec is the reference's with one leading
None; every other leaf's spec is the reference's exactly.
"""
import functools
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.sharding import specs as port  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def abstract_mesh(name: str):
    """The reference's side: a JAX mesh of those sizes with no devices."""
    from jax.sharding import AbstractMesh
    sizes = MESHES[name]
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def fake_mesh(name: str):
    sizes = MESHES[name]
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


@functools.lru_cache(maxsize=None)
def _reference_tree(arch):
    """(model, jax.eval_shape of model.init) at full size."""
    from repro.configs import get_config
    from repro.models import build_model
    model = build_model(get_config(arch))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _reference_leaves(arch, mesh_name):
    """path -> (reference spec, stored unstacked) for every leaf,
    paths as ``repro.launch.steps.param_shardings`` builds them."""
    from repro.sharding.specs import param_spec
    mesh = abstract_mesh(mesh_name)
    model, struct = _reference_tree(arch)
    segs = model.segments
    enc_layers = model.cfg.n_encoder_layers
    out = {}

    def visit(path, leaf):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        spath = "/".join(str(k) for k in keys)
        stacked, block = False, False
        if "segments" in keys:
            block = True
            i = keys.index("segments")
            if keys[0] == "encoder":
                stacked = enc_layers > 1
            else:
                seg = segs[keys[i + 1]]
                stacked = seg.length > 1 and not seg.shared
        elif "shared" in keys:
            block = True
        spec = param_spec(("seg:" if stacked else "") + spath, leaf.shape,
                          mesh)
        out[spath] = (tuple(spec), block and not stacked)
        return leaf

    jax.tree_util.tree_map_with_path(visit, struct)
    return out


def _port_tree(struct, unstacked, prefix=""):
    """The reference's shape tree as the port stores it: every block
    leaf stored unstacked gains the leading layer dim of 1."""
    if struct is None:
        return None
    if isinstance(struct, dict):
        return {k: _port_tree(v, unstacked, f"{prefix}{k}/")
                for k, v in struct.items()}
    if isinstance(struct, (list, tuple)):
        return [_port_tree(v, unstacked, f"{prefix}{i}/")
                for i, v in enumerate(struct)]
    shape = tuple(struct.shape)
    if unstacked[prefix[:-1]]:
        shape = (1,) + shape
    return types.SimpleNamespace(shape=shape)


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif tree is not None:
        out[prefix[:-1]] = tuple(tree)
    return out


def _arch_ids():
    from repro_torch.configs import ARCH_IDS
    return list(ARCH_IDS)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", _arch_ids())
def test_param_spec_equals_reference_at_full_size(arch, mesh_name):
    """Every leaf of every registered config at full size (the
    reference's ``jax.eval_shape(model.init)``): the port's spec is the
    reference's, with one leading None where the port keeps a layer dim
    of 1 the reference does not store (the one-layer rule above)."""
    from repro.configs import ARCH_IDS
    assert set(_arch_ids()) == set(ARCH_IDS)
    mesh = fake_mesh(mesh_name)
    ref = _reference_leaves(arch, mesh_name)
    _, struct = _reference_tree(arch)
    unstacked = {p: u for p, (_, u) in ref.items()}
    got = _flatten(port.param_specs(_port_tree(struct, unstacked), mesh))
    assert set(got) == set(ref)
    sharded = 0
    for path, (spec, one_layer) in ref.items():
        want = ((None,) + spec) if one_layer else spec
        assert got[path] == want, (path, got[path], want)
        sharded += any(ax is not None for ax in spec)
    assert sharded > 0


@pytest.mark.parametrize("layout", [None, "ep_dp"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharding_rules_equal_reference(mesh_name, layout, monkeypatch):
    from repro.sharding.specs import sharding_rules
    if layout:
        monkeypatch.setenv("REPRO_MOE_LAYOUT", layout)
    else:
        monkeypatch.delenv("REPRO_MOE_LAYOUT", raising=False)

    def as_tuples(rules):
        return {k: ([tuple(c) for c in v] if isinstance(v, list)
                    else tuple(v)) for k, v in rules.items()}
    want = as_tuples(sharding_rules(abstract_mesh(mesh_name)))
    assert as_tuples(port.sharding_rules(fake_mesh(mesh_name))) == want
    assert len(want["moe_buf"]) == (4 if layout else 2)


FIT_CASES = [
    ((7, 3), ("data", "model")),
    ((32, 48), ("data", "model")),
    ((16, 8, 4096), (("pod", "data"), None, "model")),
    ((512, 30, 7), (("pod", "data"), "model", None)),
    ((8, 100, 64), ("model", ("data", "model"), None)),
    ((64, 64, 64, 64), ("data",)),
    ((4,), (None,)),
]


def _fit_params():
    """Each case on each mesh that has every axis its spec names."""
    for shape, spec in FIT_CASES:
        names = {a for ax in spec if ax is not None
                 for a in (ax if isinstance(ax, tuple) else (ax,))}
        for mesh_name in sorted(MESHES):
            if names <= set(MESHES[mesh_name]):
                yield shape, spec, mesh_name


@pytest.mark.parametrize("shape,spec,mesh_name", list(_fit_params()))
def test_fit_spec_and_fits_drop_the_same_axes(shape, spec, mesh_name):
    """The reference's fit_spec on an abstract mesh of the same sizes
    (a NamedSharding needs no devices there) and its _fits, against the
    port's on the axis sizes alone."""
    from jax.sharding import PartitionSpec
    from repro.sharding.specs import _fits, fit_spec
    ref_mesh = abstract_mesh(mesh_name)
    mesh = fake_mesh(mesh_name)
    for dim, ax in zip(shape, spec):
        assert port._fits(dim, ax, mesh) == _fits(dim, ax, ref_mesh)
    want = fit_spec(shape, PartitionSpec(*spec), ref_mesh).spec
    got = port.fit_spec(shape, spec, mesh)
    assert len(got) == len(shape)
    assert tuple(got) == tuple(want) + (None,) * (len(shape) - len(want))


def test_constrain_is_identity_outside_a_mesh():
    x = torch.ones((4, 4))
    assert port.current_mesh() is None
    assert port.constrain(x, "act_btd") is x
    mesh = fake_mesh("16x16")
    with port.use_mesh_rules(mesh):
        assert port.current_mesh() is mesh
        # a plain tensor under a mesh is a rank's local shard: as it is
        assert port.constrain(x, "act_btd") is x
    assert port.current_mesh() is None


def test_partition_spec_keeps_one_name_tuples_as_names():
    from jax.sharding import PartitionSpec
    for entries in [(("data",), None), (("pod", "data"), "model"), ()]:
        assert tuple(port.PartitionSpec(*entries)) == tuple(
            PartitionSpec(*entries))


@pytest.fixture
def one_rank_world():
    import torch.distributed as dist
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_host_mesh_and_production_mesh(one_rank_world):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro.launch.mesh import make_host_mesh as ref_host_mesh
    mesh = make_host_mesh("cpu")
    ref = ref_host_mesh()
    assert tuple(mesh.mesh_dim_names) == tuple(ref.axis_names)
    assert tuple(mesh.shape) == tuple(ref.devices.shape) == (1, 1)
    assert port.axis_sizes(mesh) == dict(ref.shape)
    assert list(mesh.get_coordinate()) == [0, 0]
    for multi_pod, n, shape in [(False, 256, "(16, 16)"),
                                (True, 512, "(2, 16, 16)")]:
        with pytest.raises(RuntimeError,
                           match=re.escape(f"need {n} devices for mesh "
                                           f"{shape}, have 1")):
            make_production_mesh(multi_pod=multi_pod, device="cpu")


def _summary(stdout: str) -> str:
    line = next(ln for ln in stdout.splitlines() if ln.startswith("[serve]"))
    return line.split(" in ")[0]


def test_serve_cli_runs_every_request_as_the_reference_reports():
    """``python -m repro_torch.launch.serve --device cpu --requests 4
    --max-new 4`` exits 0 with the reference CLI's summary line: 4/4
    requests, 16 tokens (the tokens themselves differ: other weights)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    args = ["--requests", "4", "--max-new", "4"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", mod, *args, *extra], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mod, extra in (("repro_torch.launch.serve", ["--device", "cpu"]),
                           ("repro.launch.serve", []))]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    got, want = (_summary(out) for out, _ in outs)
    assert got == want == "[serve] smollm-360m-smoke: 4/4 requests, 16 tokens"
