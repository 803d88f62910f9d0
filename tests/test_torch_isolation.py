"""The port stands alone: no JAX, nothing of the JAX package, and entry
points that run on the card unless told otherwise."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "torch_quickstart.py"] + sorted(
    (ROOT / "tools").glob("torch_*.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_engine_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.serving.engine, repro_torch.bridge, "
            "repro_torch.training, repro_torch.launch.train, "
            "repro_torch.launch.serve, repro_torch.launch.mesh, "
            "repro_torch.serving.decode, repro_torch.sharding.specs, "
            "repro_torch.launch.steps, repro_torch.launch.dryrun, "
            "repro_torch.launch.hlo_analysis, repro_torch.kernels.fake; "
            "bad = [m for m in sys.modules "
            "if sys.modules[m] is not None and "
            "(m == 'repro' or m.startswith(('repro.', 'jax')))]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


PLANNING_MODULES = ("core", "core.simulator", "core.simulator_scalar",
                    "core.online_controller", "core.baselines",
                    "core.experiment", "experiments", "experiments.runner",
                    "experiments.scenarios", "experiments.results",
                    "experiments.report")


def test_planning_plane_imports_numpy_only():
    """The simulators, the online controller, the baselines and the
    experiment runner are host code: with torch and JAX blocked they
    import, and a trial runs."""
    code = ("import sys; sys.modules['torch'] = None; "
            "sys.modules['jax'] = None; import importlib; "
            f"[importlib.import_module('repro_torch.' + m) "
            f"for m in {PLANNING_MODULES!r}]; "
            "from repro_torch.experiments import TrialSpec, run_one; "
            "m = run_one(TrialSpec(seed=0, strategy='proposal', "
            "horizon_slots=5, drain_slots=40)); "
            "bad = [m for m in sys.modules if sys.modules[m] is not None "
            "and (m == 'repro' or m.startswith(('repro.', 'jax', 'torch')))]; "
            "assert not bad, bad; assert m['generated'] > 0; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.kvcache import PagedCache, cache_struct
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-360m")
    with pytest.raises(RuntimeError, match="cuda"):
        PagedServingEngine(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, quantization="int8")
    with pytest.raises(RuntimeError, match="cuda"):
        cache_struct(cfg, 2, 16, torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        PagedCache(cfg, max_rows=2, max_len=32).struct(torch.float32)
    # asked for the CPU, the same entry point builds
    eng = PagedServingEngine(cfg, device="cpu", max_rows=2, max_len=32)
    assert eng.caches[0]["k"].device.type == "cpu"
    eng = ServingEngine(cfg, device="cpu", max_batch=2, cache_len=32)
    assert eng.caches[0]["k"].device.type == "cpu"


def test_unported_architectures_refuse():
    """Every family the port serves trains now: a cross-attention block
    (beside an attn one), an encoder-decoder, the Mamba2 / shared-attn
    hybrid and MoE MLPs pass ``check_supported(cfg, "train")`` and run
    one train forward on the CPU (finite logits; the MoE terms live);
    what the port does not run, an unknown block kind, still refuses."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as ttfm
    from repro_torch.models.model import Model
    smollm = get_smoke_config("smollm-360m")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    frontend = torch.ones((1, 5, smollm.d_model))
    for cfg, batch in (
            (dataclasses.replace(smollm, block_pattern=("attn", "cross")),
             {"tokens": tokens, "frontend": frontend}),
            (dataclasses.replace(smollm, is_encoder_decoder=True,
                                 n_encoder_layers=1),
             {"tokens": tokens, "frontend": frontend}),
            (get_smoke_config("zamba2-7b"), {"tokens": tokens}),
            (dataclasses.replace(smollm, mlp_kind="moe", n_experts=4,
                                 experts_per_token=2), {"tokens": tokens})):
        ttfm.check_supported(cfg, "train")
        model = Model(cfg, device="cpu")
        logits, _, aux = model.forward(
            model.init(torch.Generator().manual_seed(0)), batch)
        assert logits.shape == (1, 4, cfg.vocab_padded)
        assert bool(torch.isfinite(logits).all())
        assert (float(aux["moe_aux_loss"]) > 0) == (cfg.mlp_kind == "moe")
    odd = dataclasses.replace(smollm)    # past the config's own check
    object.__setattr__(odd, "block_pattern", ("attn", "rwkv"))
    with pytest.raises(NotImplementedError, match="rwkv"):
        ttfm.check_supported(odd, "train")
