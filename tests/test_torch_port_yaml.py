"""The port's YAML subset (``utils/yaml_subset.py``) against PyYAML.

Every document is held both ways, exactly: what PyYAML's ``safe_dump``
writes, the subset reads to the same value as ``yaml.safe_load``; what the
subset writes, ``yaml.safe_load`` reads back to the value written. The
documents are the ones the port's tests and CLI write (pipeline configs,
a community-1 config, a pyannote.database registry, the CLI's reports)
and scalars at the edges of YAML 1.1's resolution. What lies outside the
subset raises.
"""

import math

import pytest
import yaml

from pyannote_audio_tpu_torch.utils import yaml_subset
from test_torch_port_models import one_torch_thread  # noqa: F401

COMMUNITY = {
    "version": "4.0.0",
    "pipeline": {"name": "pyannote.audio.pipelines.SpeakerDiarization",
                 "params": {"clustering": "VBxClustering",
                            "embedding": "$model/embedding",
                            "embedding_batch_size": 32,
                            "embedding_exclude_overlap": True,
                            "plda": "$model/plda",
                            "segmentation": "$model/segmentation@v1",
                            "segmentation_batch_size": 32}},
    "params": {"clustering": {"threshold": 0.6, "Fa": 0.07, "Fb": 0.8},
               "segmentation": {"min_duration_off": 0.0}},
    "freeze": {"segmentation": {"min_duration_off": 0.0}},
    "preprocessors": {"waveform": {"name": "LowerTemporalResolution",
                                   "params": {"resolution": 0.1}}},
}
REGISTRY = {
    "Databases": {"MyDB": "/data/my db/{uri}.wav",
                  "Other": ["/a/{uri}.wav", "/b/{uri}.flac"]},
    "Protocols": {"MyDB": {"SpeakerDiarization": {"P": {
        "train": {"uri": "train.lst", "annotation": "train.rttm",
                  "annotated": "train.uem"},
        "test": {"annotation": "/abs/test.rttm"}}}}},
}
REPORTS = {"seconds_per_hour": 12.3, "times_faster_than_realtime": None,
           "min_duration_off": 0.0, "der": 0.123456789012345}
EDGES = {
    "small": 1e-05, "huge": -1.5e300, "zero": -0.0, "big int": 10 ** 20,
    "inf": math.inf, "ninf": -math.inf,
    "version": "4.0.0", "float string": "1.0", "bool string": "yes",
    "null string": "null", "tilde": "~", "empty": "", "octal string": "0755",
    "hex string": "0x1F", "dot string": ".5", "date string": "2024-01-01",
    "time string": "12:30", "colon": "a: b", "hash": "#x", "inner hash":
    "a #b", "lead space": " x", "dash": "-", "dash item": "- x",
    "quote": "it's", "both quotes": "q'uote\"s", "unicode": "ü",
    "newline": "multi\nline", "blank lines": "a  b\n\n\nc", "tab": "a\tb",
    "long": "x" * 100 + " " + "y" * 10, "braces": "/x/{uri}.wav",
    "nested": [[1, 2], [3], [], {}, [{"k": [1, {"j": []}]}]],
    "empty map": {}, "empty list": [], 7: "int key", True: "bool key",
}


@pytest.mark.parametrize("document", [COMMUNITY, REGISTRY, REPORTS, EDGES],
                         ids=["community", "registry", "reports", "edges"])
def test_reads_and_writes_what_pyyaml_does(document):
    assert yaml_subset.safe_load(yaml.safe_dump(document)) == document
    ours = yaml_subset.safe_dump(document)
    assert yaml.safe_load(ours) == document
    assert yaml_subset.safe_load(ours) == document


@pytest.mark.parametrize("text", [
    "a: 0o17", "a: 0755", "a: 0x1f", "a: 0b101", "a: +12", "a: 1_000",
    "a: .5", "a: 5.", "a: -.inf", "a: ~", "a: Off", "a: NO", "a: 1e5",
    "a: 1.0e+5",
    "a:\n  b: 1 # c\n  c: 'x # y'  # z\n",
    "- a\n- b:\n    c: 1\n  d: 2\n-\n  - 3\n",
    "a:\n- 1\n- 2\nb: x\n",
    "a: x\n  continued\n\n  para\n",
    "1: 2\n'k': \"v\\u00e9\\t\"\n",
    "- - 1\n  - 2\n- []\n",
    "# a comment\n\nkey:   value  \n",
    "",
])
def test_scalars_and_layouts_resolve_as_pyyaml(text):
    assert yaml_subset.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x\n", "a: >\n  x\n",
    "a: [1, 2]", "a: {b: 1}", "---\na: 1", "%YAML 1.1\na: 1",
    "a: 12:30", "a: 2020-01-01", "? a\n: b", "<<: x"])
def test_what_lies_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        yaml_subset.safe_load(text)


def test_unknown_types_are_not_written():
    import numpy as np
    with pytest.raises(TypeError):
        yaml_subset.safe_dump({"a": np.int64(3)})


def test_pipeline_configs_go_through_the_subset(tmp_path):
    """``save_config`` writes with the subset and PyYAML reads it; a
    config PyYAML wrote loads through ``Pipeline.from_pretrained``."""
    from pyannote_audio_tpu_torch.core import pipeline as pipeline_module
    config = {"pipeline": {"name": "Pipeline"}, "params": {}}
    pipe = pipeline_module.Pipeline()
    pipe.__dict__["_config_params"] = {"der_variant": {"collar": 0.25,
                                                       "skip_overlap": False}}
    path = pipe.save_config(tmp_path)
    assert yaml.safe_load(path.read_text()) == pipe.dump_config()
    (tmp_path / "other.yaml").write_text(yaml.safe_dump(config))
    assert yaml_subset.load_file(tmp_path / "other.yaml") == config
