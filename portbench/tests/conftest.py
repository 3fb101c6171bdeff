"""Tests of the port's benchmark (``portbench/``). Run them with

    python -m pytest portbench/tests -q

The repository's own suite (``tests/``) does not collect them. Tests
marked ``cuda`` need a CUDA card and skip without one; the others run on
the CPU, where the harness is driven with the device set to the CPU and
the program's accelerator-path gates switched on, so that the CPU runs
the same semantics as the card.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a pool of four recordings of 12-30 s, lists of two: small enough for
# full-width models on the CPU
TINY_MIX = {"pool_files": 4, "median_minutes": 0.3, "sigma": 0.3,
            "min_minutes": 0.2, "max_minutes": 0.5, "files_per_list": 2,
            "sample_rate": 16000, "speakers": [2, 3],
            "f0_bands": [[90.0, 120.0], [150.0, 195.0], [240.0, 320.0]],
            "harmonics": [0.1, 0.9],
            "calibration": {"recordings": 6, "seconds": 20.0,
                            "hop_seconds": 5.0, "head_steps": 200},
            "turn_seconds": [1.0, 4.0], "gap_seconds": [0.2, 1.0],
            "overlap_share": 0.2}


@pytest.fixture
def tiny_mix():
    return dict(TINY_MIX)


@pytest.fixture
def accelerator_semantics(monkeypatch):
    """The shared sinc front-end and the shared trunk on the CPU, as on
    the card."""
    monkeypatch.setenv("PYANNOTE_TPU_SHARED_SINC", "1")
    monkeypatch.setenv("PYANNOTE_TPU_SHARED_TRUNK", "1")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
