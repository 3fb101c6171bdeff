"""The port's ``Calibration`` (an isotonic fit in numpy), its safetensors
files and ``get_calibration`` / ``get_devices`` against the JAX package's
(scikit-learn's ``IsotonicRegression`` and the ``safetensors`` package).

Tolerances: thresholds, fitted range and transforms within 1e-12
(float64; the two fits pool the same points and differ only in the order
of a pooled mean's sums), on seeded cases with tied X, NaN scores,
``increasing`` "auto" / True / False, and ``y_min`` / ``y_max`` that
clip; files read both ways exactly (0.0).
"""

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save_file as st_save_file

from pyannote_audio_tpu.core.calibration import Calibration as JaxCalibration
from pyannote_audio_tpu_torch.core.calibration import Calibration
from pyannote_audio_tpu_torch.pipelines.utils.getter import (get_calibration,
                                                             get_devices)
from pyannote_audio_tpu_torch.utils import safetensors
from test_torch_port_models import one_torch_thread  # noqa: F401

ATOL = 1e-12


def case(seed, n=300, ties=True, sign=1.0, noise=0.3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, n)
    if ties:
        x = np.round(x, 1)                       # many duplicate X
    y = 1 / (1 + np.exp(-4 * sign * x)) + noise * rng.standard_normal(n)
    return x, y


CASES = [
    dict(seed=0),
    dict(seed=1, sign=-1.0),
    dict(seed=2, ties=False, increasing=True),
    dict(seed=3, increasing=False),
    dict(seed=4, y_min=0.2, y_max=0.7),
    dict(seed=5, y_min=None, y_max=None, noise=1.0),
    dict(seed=6, n=12, noise=2.0),
    dict(seed=7, n=3),
]


def fit_both(seed, n=300, ties=True, sign=1.0, noise=0.3, **kwargs):
    x, y = case(seed, n, ties, sign, noise)
    return (Calibration(**kwargs).fit(x, y),
            JaxCalibration(**kwargs).fit(x, y))


@pytest.mark.parametrize("config", CASES)
def test_isotonic_fit_matches_sklearn(config):
    ours, theirs = fit_both(**config)
    assert ours.increasing_ == bool(theirs.increasing_)
    np.testing.assert_array_equal(ours.X_thresholds_, theirs.X_thresholds_)
    np.testing.assert_allclose(ours.y_thresholds_, theirs.y_thresholds_,
                               rtol=0, atol=ATOL)
    assert (ours.X_min_, ours.X_max_) == (theirs.X_min_, theirs.X_max_)
    rng = np.random.default_rng(100)
    scores = rng.uniform(-1.5, 1.5, (7, 11))    # past both ends too
    scores[rng.random(scores.shape) < 0.2] = np.nan
    a, b = ours.safe_transform(scores), theirs.safe_transform(scores)
    assert a.shape == scores.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(scores))
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_sample_weights_and_constant_fits_match_sklearn():
    x, y = case(8, n=50)
    w = np.random.default_rng(9).uniform(0.0, 2.0, 50)
    w[::7] = 0.0                                 # dropped points
    ours = Calibration().fit(x, y, sample_weight=w)
    theirs = JaxCalibration().fit(x, y, sample_weight=w)
    np.testing.assert_allclose(ours.y_thresholds_, theirs.y_thresholds_,
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ours.X_thresholds_, theirs.X_thresholds_)
    flat_x = np.full(5, 0.3)
    ours = Calibration().fit(flat_x, np.arange(5.0) / 5)
    theirs = JaxCalibration().fit(flat_x, np.arange(5.0) / 5)
    np.testing.assert_allclose(ours.transform([0.0, 0.3, 1.0]),
                               theirs.transform([0.0, 0.3, 1.0]), atol=ATOL)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_breakpoints_read_both_ways(tmp_path, writer):
    ours, theirs = fit_both(seed=10, y_min=0.1)
    path = tmp_path / "calibration.safetensors"
    (ours if writer == "port" else theirs).save(path)
    loaded = {"port": Calibration.from_file(path),
              "jax": JaxCalibration.from_file(path)}
    scores = np.linspace(-1.2, 1.2, 41)
    expected = theirs.transform(scores)
    for name, calibration in loaded.items():
        np.testing.assert_allclose(calibration.transform(scores), expected,
                                   rtol=0, atol=ATOL, err_msg=name)
    raw_ours, raw_theirs = safetensors.load_file(path), st_load_file(
        str(path))
    assert raw_ours.keys() == raw_theirs.keys()
    for key in raw_theirs:
        assert raw_ours[key].dtype == raw_theirs[key].dtype
        np.testing.assert_array_equal(raw_ours[key], raw_theirs[key])


def test_safetensors_round_trips_every_dtype(tmp_path):
    rng = np.random.default_rng(11)
    tensors = {"f64": rng.standard_normal((3, 4)),
               "f32": rng.standard_normal(5).astype(np.float32),
               "f16": rng.standard_normal((2, 2)).astype(np.float16),
               "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
               "i8": np.array([-1, 2], dtype=np.int8),
               "u8": np.array([255, 0, 7], dtype=np.uint8),
               "b": np.array([True, False]),
               "scalar": np.array(2.5),
               "empty": np.zeros((0, 3), dtype=np.float32)}
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.st"
    safetensors.save_file(tensors, ours, metadata={"format": "np"})
    st_save_file(tensors, str(theirs))
    for loaded in (st_load_file(str(ours)), safetensors.load_file(theirs),
                   safetensors.load_file(ours)):
        assert loaded.keys() == tensors.keys()
        for key, value in tensors.items():
            assert loaded[key].dtype == value.dtype
            np.testing.assert_array_equal(loaded[key], value)
    data = bytearray(ours.read_bytes())
    data[:8] = (len(data) * 2).to_bytes(8, "little")
    (tmp_path / "bad.safetensors").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="header length"):
        safetensors.load_file(tmp_path / "bad.safetensors")


def test_get_calibration_resolves_its_four_forms(tmp_path, monkeypatch):
    # hub ids resolve through utils/hf_hub.py: no snapshot root, an empty
    # cache and a closed local endpoint, so nothing leaves the machine
    monkeypatch.setenv("PYANNOTE_TPU_HUB", "")
    monkeypatch.setenv("PYANNOTE_TPU_CACHE", str(tmp_path / "hub_cache"))
    monkeypatch.setenv("HF_ENDPOINT", "http://127.0.0.1:9")
    ours, theirs = fit_both(seed=12)
    (tmp_path / "sub").mkdir()
    theirs.save(tmp_path / "sub" / "calibration.safetensors")
    scores = np.linspace(-1.0, 1.0, 9)
    expected = theirs.transform(scores)
    assert get_calibration(ours) is ours
    for form in ({"checkpoint": str(tmp_path), "subfolder": "sub"},
                 tmp_path / "sub" / "calibration.safetensors",
                 str(tmp_path / "sub")):
        np.testing.assert_allclose(get_calibration(form).transform(scores),
                                   expected, rtol=0, atol=ATOL)
    for hub_id in ("pyannote/calibration",
                   {"checkpoint": "pyannote/calibration",
                    "subfolder": "plda"}):
        with pytest.raises(ValueError, match="local"):
            get_calibration(hub_id)


def test_get_devices_is_round_robin_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_devices(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert get_devices(5) == [torch.device("cuda", i)
                              for i in (0, 1, 0, 1, 0)]
