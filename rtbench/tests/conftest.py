"""The benchmark's CPU tests: a configuration cut to a tiny size (64x48,
about 700 triangles, one warm frame, every pixel checked), which the
program renders with its sweep's plain twin. Run from the repository's root:

    python -m pytest rtbench/tests -q
"""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(config_name: str) -> dict:
    """Overrides that cut a configuration to a test's size."""
    with open(ROOT / "rtbench" / "configs" / f"{config_name}.json") as f:
        scene = json.load(f)["scene"]
    return dict(width=64, height=48, scene=dict(scene, detail=0.3))


TINY_TRAFFIC = dict(warm_units=1, traced_units=2, check_pixels=64 * 48)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels have no CPU mode")
    return torch.device("cuda")
