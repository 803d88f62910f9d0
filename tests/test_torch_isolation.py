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
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("torch_*.py"))


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
            "repro_torch.training, repro_torch.launch.train; "
            "bad = [m for m in sys.modules "
            "if sys.modules[m] is not None and "
            "(m == 'repro' or m.startswith(('repro.', 'jax')))]; "
            "assert not bad, bad; print('ok')")
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
    """Kinds the port does not run yet refuse at construction: a Mamba2
    block (beside a Mamba1 one) and MoE MLPs."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    mamba = get_smoke_config("falcon-mamba-7b")
    for cfg in (dataclasses.replace(mamba, block_pattern=("mamba1", "mamba2")),
                dataclasses.replace(get_smoke_config("smollm-360m"),
                                    mlp_kind="moe")):
        with pytest.raises(NotImplementedError):
            Model(cfg, device="cpu")
