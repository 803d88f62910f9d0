import os
import sys

# smoke tests and benches must see ONE device — the 512-device flag is set
# only inside launch/dryrun.py (see the brief).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    # tier split (TOOLING.md §Test tiers): tier-1 = `make test` =
    # `pytest -m "not tier2"`; tier2 marks the slow parity sweeps that
    # only `make test-full` (and a bare `pytest` run) executes.
    config.addinivalue_line(
        "markers",
        "tier2: slow parity sweep — excluded from tier-1 (`make test`), "
        "run by `make test-full`")
    # card-only tests of the PyTorch/CUDA port (tests/test_torch_*.py):
    # they skip, with a reason, where torch.cuda finds no device
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc — skipped without a card")
