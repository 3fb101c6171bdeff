"""The port's config surface against the JAX package's, and the float32
pinning of its exact path.

``Pipeline.from_pretrained`` on a community-1 style snapshot (a directory
with ``config.yaml``, ``segmentation/`` and ``embedding/`` reference
checkpoints and ``plda/``) and on the same config as a dict;
``expand_subfolders``, ``freeze`` / ``instantiate`` and ``parameters``
against the JAX ``Pipeline``; ``dump_config`` round trips; class paths of
the reference and of the JAX package resolve to the port; hub ids raise.
Checkpoints: what the port's writer stores loads back bit for bit, reads
in the JAX package (PyanNet log-probs within 1e-5), and pickled reference
specifications load through the shim. ``to(device)``. Then the pinning:
each float32 site runs with TF32 off and restores torch's flags, even
after ``torch.set_float32_matmul_precision("high")``; the bf16 sites leave
them alone. On the CPU the flags change no result; the card check is in
``chip_smoke.py`` (k).
"""

import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from pyannote_audio_tpu.core import pipeline as jax_pipeline_module
from pyannote_audio_tpu.core.model import Model as JaxModel
from pyannote_audio_tpu.core.parameter import (ParamDict as JaxParamDict,
                                               Uniform as JaxUniform)
from pyannote_audio_tpu_torch import Model, Pipeline
from pyannote_audio_tpu_torch.core import pipeline as pipeline_module
from pyannote_audio_tpu_torch.core.model import Specifications
from pyannote_audio_tpu_torch.core.parameter import ParamDict, Uniform
from pyannote_audio_tpu_torch.core.plda import PLDA
from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
    WeSpeakerResNet34
from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from pyannote_audio_tpu_torch.utils.convert import (pyannet_state_dict,
                                                    wespeaker_state_dict,
                                                    write_reference_checkpoint)
from pyannote_audio_tpu_torch.utils.runtime import exact_float32
from test_torch_port_models import (SMALL_BLOCKS, SMALL_CHANNELS,
                                    jax_pyannet, jax_wespeaker)

CONFIG_PARAMS = {"segmentation": {"min_duration_off": 0.0},
                 "clustering": {"threshold": 0.6, "Fa": 0.07, "Fb": 0.8}}


def write_snapshot(root, seg, emb, plda, clustering=None):
    """A community-1 style snapshot under ``root`` from a JAX PyanNet and
    a JAX SmallWeSpeaker (their weights through the port's converters and
    writer) and PLDA parameters; returns the config it wrote."""
    spec = seg.specifications.to_dict()
    hparams = dict(seg.hparams, sample_rate=16000, num_channels=1)
    write_reference_checkpoint(pyannet_state_dict(seg.params, seg.hparams),
                               "PyanNet", hparams, spec,
                               root / "segmentation")
    write_reference_checkpoint(
        wespeaker_state_dict(emb.params), "WeSpeakerResNet34",
        {"num_blocks": list(SMALL_BLOCKS), "m_channels": SMALL_CHANNELS,
         "compute_dtype": "float32", "dither": 0.0}, None,
        root / "embedding")
    (root / "plda").mkdir(parents=True, exist_ok=True)
    np.savez(root / "plda" / "xvec_transform.npz", mean1=plda["mean1"],
             mean2=plda["mean2"], lda=plda["lda"])
    np.savez(root / "plda" / "plda.npz", mu=plda["plda_mu"],
             tr=plda["plda_tr"], psi=plda["plda_psi"])
    config = {
        "version": "4.0.0",
        "pipeline": {
            "name": "pyannote.audio.pipelines.SpeakerDiarization",
            "params": {"clustering": "VBxClustering",
                       "embedding": "$model/embedding",
                       "embedding_batch_size": 16,
                       "embedding_exclude_overlap": True,
                       "plda": "$model/plda",
                       "segmentation": "$model/segmentation",
                       "segmentation_batch_size": 16}},
        "params": {"segmentation": {"min_duration_off": 0.0},
                   "clustering": clustering or CONFIG_PARAMS["clustering"]},
    }
    with open(root / "config.yaml", "w") as f:
        yaml.safe_dump(config, f)
    return config


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    from test_torch_port_vbx import plda_params
    root = tmp_path_factory.mktemp("snapshot")
    seg, emb = jax_pyannet(duration=10.0, seed=3), jax_wespeaker(seed=4)
    config = write_snapshot(root, seg, emb, plda_params(5))
    return root, config, seg, emb


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _same_pipeline(a, b):
    assert type(a) is type(b) is SpeakerDiarization
    assert a.klustering == b.klustering == "VBxClustering"
    assert a.parameters(instantiated=True) == \
        b.parameters(instantiated=True)
    for x, y in ((a._segmentation.model, b._segmentation.model),
                 (a._embedding, b._embedding)):
        sx, sy = _state(x), _state(y)
        assert sx.keys() == sy.keys()
        for key in sx:
            assert torch.equal(sx[key], sy[key]), key
    np.testing.assert_array_equal(a.clustering.plda.phi,
                                  b.clustering.plda.phi)


def test_snapshot_dir_file_and_dict_give_the_same_pipeline(snapshot):
    root, config, _, _ = snapshot
    from_dir = Pipeline.from_pretrained(root, device="cpu")
    from_file = Pipeline.from_pretrained(root / "config.yaml", device="cpu")
    from_dict = Pipeline.from_pretrained(dict(config, checkpoint=str(root)),
                                         device="cpu")
    assert from_dir.parameters(instantiated=True) == {
        "segmentation": {"min_duration_off": 0.0},
        "clustering.threshold": 0.6, "clustering.Fa": 0.07,
        "clustering.Fb": 0.8}
    assert from_dir.embedding_exclude_overlap is True
    _same_pipeline(from_dir, from_file)
    _same_pipeline(from_dir, from_dict)
    # pipeline_params override the config's constructor params
    other = Pipeline.from_pretrained(
        root, device="cpu", pipeline_params={"embedding_batch_size": 3})
    assert other.embedding_batch_size == 3


@pytest.mark.parametrize("name", ["segmentation", "embedding"])
def test_loaded_state_dicts_equal_what_was_written(snapshot, name):
    root, _, seg, emb = snapshot
    written = torch.load(root / name / "pytorch_model.bin",
                         weights_only=True)["state_dict"]
    model = Model.from_pretrained(root, subfolder=name)
    assert not model.training
    state = model.state_dict()
    assert state.keys() == written.keys()
    for key in written:
        assert torch.equal(state[key], written[key]), key
    if name == "segmentation":
        assert isinstance(model, PyanNet)
        assert model.specifications == Specifications(
            duration=10.0, classes=["a", "b", "c"], powerset_max_classes=2)
    else:
        assert isinstance(model, WeSpeakerResNet34)
        assert model.compute_dtype == torch.float32


def test_jax_package_reads_the_port_checkpoint(snapshot):
    """The JAX ``Model.from_pretrained`` reads a PyanNet checkpoint the
    port wrote and gives the port's log-probs within 1e-5."""
    root, _, _, _ = snapshot
    path = root / "segmentation" / "pytorch_model.bin"
    theirs = JaxModel.from_pretrained(path)
    ours = Model.from_pretrained(path)
    wav = (0.1 * np.random.default_rng(6).standard_normal((2, 1, 32000))
           ).astype(np.float32)
    expected = np.asarray(theirs.module.apply(
        jax.tree_util.tree_map(jnp.asarray, theirs.params),
        jnp.asarray(wav)))
    with torch.no_grad():
        got = ours(torch.from_numpy(wav)).numpy()
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, atol=1e-5)


@pytest.mark.parametrize("layout", ["pickled reference classes",
                                    "plain dict"])
def test_reference_specifications_load_through_the_shim(tmp_path, layout):
    from test_reference_checkpoint import _install_fake_reference_modules
    port = PyanNet(lstm_hidden=16, linear_hidden=16,
                   generator=torch.Generator().manual_seed(7))
    spec = {"problem": "MONO_LABEL_CLASSIFICATION", "resolution": "FRAME",
            "duration": 5.0, "min_duration": None, "warm_up": (0.0, 0.0),
            "classes": ["s1", "s2", "s3"], "powerset_max_classes": 2,
            "permutation_invariant": True}
    checkpoint = {"state_dict": port.state_dict(),
                  "hyper_parameters": dict(port.reference_hparams(),
                                           task=None),
                  "pyannote.audio": {"architecture": {
                      "module": "pyannote.audio.models.segmentation",
                      "class": "PyanNet"}}}
    # a derived buffer of the reference's sinc filterbank is ignored
    checkpoint["state_dict"]["sincnet.conv1d.0.filterbank.n_"] = \
        torch.zeros(125)
    if layout == "plain dict":
        checkpoint["pyannote.audio"]["specifications"] = spec
        torch.save(checkpoint, tmp_path / "pytorch_model.bin")
    else:
        created, Spec, Problem, Resolution = \
            _install_fake_reference_modules()
        try:
            checkpoint["pyannote.audio"]["specifications"] = Spec(**dict(
                spec, problem=Problem.MONO_LABEL_CLASSIFICATION,
                resolution=Resolution.FRAME))
            torch.save(checkpoint, tmp_path / "pytorch_model.bin")
        finally:
            for name in created:
                del sys.modules[name]
    model = Model.from_pretrained(tmp_path)
    assert model.specifications.duration == 5.0
    assert model.specifications.permutation_invariant is True
    assert model.specifications.powerset_max_classes == 2
    assert torch.equal(model.lstm.weight_hh_l1, port.lstm.weight_hh_l1)


def test_unported_architectures_and_hub_ids_raise(tmp_path):
    torch.save({"state_dict": {}, "pyannote.audio": {"architecture": {
        "class": "SincTDNN"}}}, tmp_path / "pytorch_model.bin")
    with pytest.raises(ValueError, match="not ported yet"):
        Model.from_pretrained(tmp_path)
    for call in (lambda: Pipeline.from_pretrained(
                     "pyannote/speaker-diarization-community-1"),
                 lambda: Model.from_pretrained("pyannote/segmentation-3.0"),
                 lambda: SpeakerDiarization(
                     segmentation="pyannote/segmentation-3.0",
                     device="cpu")):
        with pytest.raises(ValueError, match="local"):
            call()


@pytest.mark.parametrize("config", [
    {"a": "$model/embedding", "b": ["$model/plda@v2", 3, "x"],
     "c": {"d": "$model@main"}, "e": "$modelx/seg"},
    {"pipeline": {"params": {"segmentation": "$model/seg/sub@r1"}}},
])
def test_expand_subfolders_matches_jax(config):
    assert pipeline_module.expand_subfolders(config, "/snap") == \
        jax_pipeline_module.expand_subfolders(config, "/snap")


@pytest.mark.parametrize("name", [
    "pyannote.audio.pipelines.SpeakerDiarization",
    "pyannote_audio_tpu.pipelines.speaker_diarization.SpeakerDiarization",
    "pyannote_audio_tpu_torch.pipelines.SpeakerDiarization",
    "SpeakerDiarization"])
def test_class_paths_resolve_to_the_port(name):
    assert pipeline_module.get_class_by_name(
        name, default_module_name="pyannote_audio_tpu_torch.pipelines") \
        is SpeakerDiarization


def _toy(module, ParamDictClass, UniformClass):
    """The same small pipeline in either package: a declared ParamDict, a
    declared Uniform and a sub-pipeline with one."""
    class Sub(module.Pipeline):
        def __init__(self):
            super().__init__()
            self.threshold = UniformClass(0.0, 1.0)

    class Toy(module.Pipeline):
        def __init__(self):
            super().__init__()
            self.segmentation = ParamDictClass(
                min_duration_off=UniformClass(0.0, 1.0),
                onset=UniformClass(0.0, 1.0))
            self.scale = UniformClass(0.0, 5.0)
            self.clustering = Sub()
    return Toy()


@pytest.mark.parametrize("steps", [
    [("instantiate", {"segmentation": {"min_duration_off": 0.1,
                                       "onset": 0.5},
                      "scale": 2.0, "clustering": {"threshold": 0.3}}),
     ("instantiate", {"segmentation": {"onset": 0.7}})],
    [("freeze", {"segmentation": {"min_duration_off": 0.25}, "scale": 1.0}),
     ("instantiate", {"segmentation": {"min_duration_off": 0.9,
                                       "onset": 0.4}, "scale": 3.0,
                      "clustering": {"threshold": 0.6}})],
    [("freeze", {"clustering": {"threshold": 0.2}}),
     ("instantiate", {"clustering": {"threshold": 0.8}, "scale": 0.5})],
])
def test_freeze_and_instantiate_match_jax(steps):
    ours = _toy(pipeline_module, ParamDict, Uniform)
    theirs = _toy(jax_pipeline_module, JaxParamDict, JaxUniform)
    for method, params in steps:
        getattr(ours, method)(params)
        getattr(theirs, method)(params)
    assert ours.parameters(instantiated=True) == \
        theirs.parameters(instantiated=True)
    assert sorted(ours.parameters()) == sorted(theirs.parameters())
    # declared (a Parameter's repr) or instantiated, alike
    assert repr(ours.segmentation) == repr(theirs.segmentation)
    assert repr(ours.scale) == repr(theirs.scale)


def test_freeze_beats_instantiate_in_a_config(snapshot):
    root, config, _, _ = snapshot
    frozen = dict(config, checkpoint=str(root),
                  freeze={"segmentation": {"min_duration_off": 0.5},
                          "clustering": {"Fa": 0.2}})
    pipeline = Pipeline.from_pretrained(frozen, device="cpu")
    assert pipeline.segmentation.min_duration_off == 0.5
    assert pipeline.clustering.Fa == 0.2
    pipeline.instantiate({"clustering": {"Fa": 0.3, "Fb": 2.0}})
    assert pipeline.clustering.Fa == 0.2 and pipeline.clustering.Fb == 2.0


def test_dump_config_round_trip(snapshot, tmp_path):
    root, _, _, _ = snapshot
    pipeline = Pipeline.from_pretrained(root, device="cpu")
    pipeline.instantiate({"clustering": {"threshold": 0.55},
                          "segmentation": {"min_duration_off": 0.125}})
    config = pipeline.dump_config()
    assert config["params"]["clustering"]["threshold"] == 0.55
    again = Pipeline.from_pretrained(config)
    _same_pipeline(pipeline, again)
    assert again.device == torch.device("cpu")
    saved = pipeline.save_config(tmp_path / "dumped")
    _same_pipeline(pipeline, Pipeline.from_pretrained(saved))
    assert yaml.safe_load(saved.read_text()) == config


def test_to_moves_the_pipeline_and_drops_device_caches(snapshot):
    root, _, _, _ = snapshot
    pipeline = Pipeline.from_pretrained(root, device="cpu")
    inference = pipeline._segmentation
    inference._powerset.to_multilabel(torch.zeros(1, 2, 7))
    assert inference._powerset._mapping_on
    assert pipeline.to("cpu") is pipeline
    assert not inference._powerset._mapping_on
    assert pipeline.clustering.device == torch.device("cpu")
    assert next(pipeline._embedding.parameters()).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            pipeline.to("cuda")
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            pipeline.cuda()


# -- float32 pinned at the exact path's sites -----------------------------------

def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_allowed():
    """torch's flags as a process that asked for TF32 sets them."""
    saved = _flags()
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision("highest")
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_exact_float32_pins_and_restores(tf32_allowed):
    assert _flags() == (True, True)
    with exact_float32():
        assert _flags() == (False, False)
        with exact_float32():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    with pytest.raises(KeyError):
        with exact_float32():
            raise KeyError
    assert _flags() == (True, True)


def _site(name):
    """(callable running the site, torch function it reaches)."""
    gen = torch.Generator().manual_seed(8)
    if name in ("lstm projection", "plain recurrence"):
        model = PyanNet(lstm_hidden=8, linear_hidden=8, generator=gen)
        x = torch.randn(2, 30, 60, generator=gen)
        probe = "matmul" if name == "lstm projection" else "recurrence"
        return (lambda: model.lstm(x)), probe
    if name.startswith("sincnet"):
        model = PyanNet(lstm_hidden=8, linear_hidden=8, generator=gen)
        x = torch.randn(2, 1, 4000, generator=gen)
        return (lambda: model.sincnet(x)), "conv1d"
    if name == "pyannet head":
        model = PyanNet(lstm_hidden=8, linear_hidden=8, generator=gen)
        x = torch.randn(2, 30, 60, generator=gen)
        return (lambda: model._head(x)), "linear"
    if name.startswith("trunk") or name == "embedding projection":
        dtype = torch.bfloat16 if "bf16" in name else torch.float32
        model = WeSpeakerResNet34(num_blocks=(1, 1, 1, 1), m_channels=4,
                                  compute_dtype=dtype, generator=gen)
        x = torch.randn(2, 1, 8000, generator=gen)
        if name == "embedding projection":
            frames = torch.randn(2, 20, 320, generator=gen)
            weights = torch.rand(2, 3, 20, generator=gen)
            return (lambda: model.embed(frames, weights)), "linear"
        return (lambda: model.frames(x)), "conv2d"
    raise ValueError(name)


@pytest.mark.parametrize("name,pinned", [
    ("lstm projection", True), ("plain recurrence", True),
    ("pyannet head", True), ("sincnet float32", True),
    ("sincnet bf16", False), ("trunk float32", True), ("trunk bf16", False),
    ("embedding projection", True)])
def test_float32_sites_run_with_tf32_off(tf32_allowed, monkeypatch, name,
                                         pinned):
    """Each float32 site sees TF32 off at its matmuls and convolutions
    after ``set_float32_matmul_precision("high")``, and leaves the flags
    as they were; the bf16 sites do not touch them."""
    from pyannote_audio_tpu_torch.ops import lstm as lstm_ops
    monkeypatch.setenv("PYANNOTE_TPU_SEG_BF16",
                       "1" if name == "sincnet bf16" else "0")
    run, probe = _site(name)
    seen = []

    def recording(fn):
        def wrapped(*args, **kwargs):
            seen.append(_flags())
            return fn(*args, **kwargs)
        return wrapped
    if probe == "recurrence":
        monkeypatch.setattr(lstm_ops, "recurrent_product",
                            recording(lstm_ops.recurrent_product))
    elif probe == "matmul":
        monkeypatch.setattr(torch, "matmul", recording(torch.matmul))
    else:
        monkeypatch.setattr(torch.nn.functional, probe,
                            recording(getattr(torch.nn.functional, probe)))
    with torch.no_grad():
        out = run()
    assert torch.isfinite(out.float()).all()
    assert seen
    expected = (False, False) if pinned else (True, True)
    assert all(flags == expected for flags in seen), seen
    assert _flags() == (True, True)
