"""The port's protocol preprocessors against the JAX package's.

A pipeline config naming each preprocessor (by bare class name, by the
reference's ``pyannote.audio.utils.preprocessors`` path and by the JAX
package's) loads in both packages; each loaded preprocessor gives, on the
same corpus file, what the JAX package's gives: annotations with the same
(start, end, label) tracks, the same waveform (exactly) and sample rate.
"""

import numpy as np
import pytest

from corpus import make_file
from pyannote_audio_tpu.core.pipeline import Pipeline as JaxPipeline
from pyannote_audio_tpu.utils import preprocessors as jax_preprocessors
from pyannote_audio_tpu_torch import Pipeline
from pyannote_audio_tpu_torch.core import pipeline as pipeline_module
from pyannote_audio_tpu_torch.utils import preprocessors
from test_torch_port_train import _port_file

PREPROCESSORS = {
    "coarse": ("LowerTemporalResolution", {"resolution": 0.5}),
    "meta": ("DeriveMetaLabels", {
        "classes": ["alice", "bob", "carol"],
        "unions": {"alice_or_bob": ["alice", "bob"]},
        "intersections": {"alice_and_bob": ["alice", "bob"]},
        "mapping": {"dave": "carol"}}),
    "waveform": ("Waveform", {"sample_rate": 16000}),
    "sample_rate": ("SampleRate", {"sample_rate": 8000}),
}
PREFIXES = ("", "pyannote.audio.utils.preprocessors.",
            "pyannote_audio_tpu.utils.preprocessors.")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("preprocessors")
    jax_file = make_file(root / "pre.wav",
                         [("alice", 0.23, 3.61), ("bob", 2.97, 6.04),
                          ("dave", 5.5, 7.77), ("alice", 8.12, 8.14)],
                         duration=9.0, seed=3)
    return jax_file, _port_file(jax_file)


def _config(prefix):
    return {"pipeline": {
        "name": "pyannote.audio.pipelines.OracleVoiceActivityDetection",
        "params": {}},
        "preprocessors": {key: {"name": prefix + name, "params": params}
                          for key, (name, params) in PREPROCESSORS.items()}}


def _tracks(annotation):
    return sorted((round(s.start, 9), round(s.end, 9), label)
                  for s, _, label in annotation.itertracks(yield_label=True))


@pytest.mark.parametrize("prefix", PREFIXES)
def test_config_preprocessors_load_and_agree_with_jax(files, prefix):
    ours = Pipeline.from_pretrained(_config(prefix), device="cpu")
    theirs = JaxPipeline.from_pretrained(_config(prefix))
    for key, (name, _) in PREPROCESSORS.items():
        assert type(ours._preprocessors[key]) is getattr(preprocessors, name)
        assert type(theirs._preprocessors[key]) is \
            getattr(jax_preprocessors, name)
    jax_file, port_file = files
    for key in ("coarse", "meta"):
        assert _tracks(ours._preprocessors[key](port_file)) == \
            _tracks(theirs._preprocessors[key](jax_file)), key
    np.testing.assert_array_equal(
        ours._preprocessors["waveform"](port_file),
        theirs._preprocessors["waveform"](jax_file))
    assert ours._preprocessors["sample_rate"](port_file) == \
        theirs._preprocessors["sample_rate"](jax_file) == 8000
    # each file the pipeline prepares carries every preprocessor's output
    prepared = ours.prepare_one(dict(port_file))
    assert prepared["sample_rate"] == 8000
    assert _tracks(prepared["coarse"]) == _tracks(
        theirs._preprocessors["coarse"](jax_file))


def test_bare_preprocessor_name_no_longer_raises():
    """A bare class name raised ``ValueError: cannot resolve class name``
    before the port had the module and passed it as the default."""
    Klass = pipeline_module.get_class_by_name(
        "LowerTemporalResolution",
        default_module_name="pyannote_audio_tpu_torch.utils.preprocessors")
    assert Klass is preprocessors.LowerTemporalResolution
    pipeline = Pipeline.from_pretrained(
        {"pipeline": {"name": "OracleVoiceActivityDetection", "params": {}},
         "preprocessors": {"annotation": {
             "name": "LowerTemporalResolution"}}}, device="cpu")
    assert isinstance(pipeline._preprocessors["annotation"],
                      preprocessors.LowerTemporalResolution)


def test_no_preprocessors_set_none():
    """As in the JAX package, a config without preprocessors gives the
    pipeline none."""
    config = {"pipeline": {"name": "OracleVoiceActivityDetection",
                           "params": {}}}
    for pipeline in (Pipeline.from_pretrained(config, device="cpu"),
                     JaxPipeline.from_pretrained(config)):
        assert not pipeline.__dict__.get("_preprocessors")
