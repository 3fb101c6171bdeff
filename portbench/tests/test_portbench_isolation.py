"""Nothing the benchmark runs imports JAX or the JAX package, and a run
without a card prints no result."""

import json
import os
import subprocess
import sys

from portbench.harness import ROOT

IMPORT_ALL = r"""
import importlib, json, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
here = Path(sys.argv[1]) / "portbench"
import portbench.harness as harness
import portbench.capture, portbench.control, portbench.flops
import portbench.diarization
import portbench.snapshot, portbench.weights, portbench.calibration
import portbench.traffic.generator
import portbench.reference.check, portbench.reference.pipeline
import portbench.reference.sseriouss, portbench.reference.clustering
bench = harness.load_benchmark()
for entry in bench["configs"]:
    harness.load_module(here / "configs" / f"{entry['name']}.py",
                        "c_" + entry["name"].replace("-", "_"))
for metric in bench["per_layer"]:
    harness.load_module(here / "metrics" / f"{metric['name']}.py",
                        "m_" + metric["name"])
print(json.dumps(sorted({name.split(".")[0] for name in sys.modules})))
"""


def test_nothing_imports_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "pyannote_audio_tpu_torch" not in top  # configs import it lazily
    for forbidden in ("jax", "jaxlib", "flax", "pyannote_audio_tpu"):
        assert forbidden not in top


def test_names_are_compared_whole(monkeypatch):
    """The port's name begins with the JAX package's: a prefix match would
    flag it, a whole-name match does not."""
    import types

    from portbench.harness import forbidden_modules
    for name in ("pyannote_audio_tpu_torch.fake", "jaxlike"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    before = forbidden_modules()
    assert "jaxlike" not in before
    assert not [m for m in before if m.startswith("pyannote_audio_tpu_")]
    monkeypatch.setitem(sys.modules, "pyannote_audio_tpu.fake",
                        types.ModuleType("pyannote_audio_tpu.fake"))
    assert "pyannote_audio_tpu" in forbidden_modules()


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "community1.batch",
         "--seed", str(2 ** 40 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
