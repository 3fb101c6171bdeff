"""Speaker-embedding training on the port against the JAX package's.

The ArcFace loss and its gradient within 1e-5 relative; the ArcFace
task's batches (X, y and each batch's duration, the short-turn zero-pad
included) equal to the JAX task's from the same protocol and seed; one
``Trainer`` step and three Adam steps (lr 1e-3) of ``SimpleEmbeddingModel``
and of a WeSpeaker ResNet narrowed to (1, 1, 1, 1) x 8 (float32 trunk,
BatchNorm statistics perturbed) against the JAX trainer's step from the
same weights and prototypes: the loss within 1e-5 relative at each step,
every parameter and prototype within 2 lr after 3 steps, and the
ResNet's running statistics unchanged. The JAX step is run with
``frozen_prefixes=("batch_stats",)``: the JAX trainer's own step moves
the running statistics as parameters (they sit in its differentiated
tree, and Adam steps them by lr), which the port does not do; a test
shows that. ``speaker_verification.main`` on a seeded trial protocol
gives the JAX ``main``'s EER within 1e-6; ``models.embedding.convert``
on a seeded ``avg_model.pt``, with and without the ``resnet.`` prefix,
writes the weights as they are, and the JAX converter's model gives the
same embeddings within 2e-3 (the WeSpeaker float32 bound of
tests/test_torch_port_embedders.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from corpus import make_file
from pyannote_audio_tpu.core.model import Model as JaxModel
from pyannote_audio_tpu.models.embedding import convert as jax_convert
from pyannote_audio_tpu.models.embedding import wespeaker as jax_wespeaker
from pyannote_audio_tpu.models.embedding.debug import \
    SimpleEmbeddingModel as JaxSimpleEmbeddingModel
from pyannote_audio_tpu.pipelines import speaker_verification as \
    jax_verification
from pyannote_audio_tpu.tasks import embedding as jax_embedding
from pyannote_audio_tpu.train.trainer import make_train_step
from pyannote_audio_tpu.utils.database import Protocol as JaxProtocol
from pyannote_audio_tpu_torch.core.model import Model
from pyannote_audio_tpu_torch.metrics.auroc import BinnedAUROC
from pyannote_audio_tpu_torch.metrics.streaming import EqualErrorRate
from pyannote_audio_tpu_torch.models.embedding import convert, wespeaker
from pyannote_audio_tpu_torch.models.embedding.debug import \
    SimpleEmbeddingModel
from pyannote_audio_tpu_torch.pipelines import speaker_verification
from pyannote_audio_tpu_torch.tasks import embedding
from pyannote_audio_tpu_torch.train import Trainer
from pyannote_audio_tpu_torch.train.trainer import train_mode
from pyannote_audio_tpu_torch.utils.convert import (
    arcface_prototypes, debug_embedding_state_dict, wespeaker_state_dict)
from pyannote_audio_tpu_torch.utils.database import Protocol
from test_torch_port_models import perturb
from test_torch_port_train import _port_file
from test_torch_port_models import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-5
LR = 1e-3
EMBEDDING_ATOL = 2e-3
EER_ATOL = 1e-6
TASK = dict(duration=3.0, min_duration=1.0, num_classes_per_batch=3,
            num_chunks_per_class=2, seed=5)


@pytest.fixture(scope="module")
def protocols(tmp_path_factory):
    """(JAX protocol, port protocol): four speakers over two files, turns
    of 0.5-6 s (shorter than min_duration, between it and the duration,
    and longer)."""
    root = tmp_path_factory.mktemp("arcface_corpus")
    train = [make_file(root / "e0.wav",
                       [("alice", 0.2, 2.0), ("bob", 2.3, 7.9),
                        ("carol", 8.1, 8.6), ("alice", 9.0, 13.5)],
                       duration=14.0, seed=11),
             make_file(root / "e1.wav",
                       [("dave", 0.4, 4.1), ("carol", 4.5, 6.0),
                        ("bob", 6.2, 8.5), ("dave", 9.0, 11.0)],
                       duration=12.0, seed=12)]
    return (JaxProtocol("Debug.SpeakerDiarization.Arc", {"train": train}),
            Protocol("Debug.SpeakerDiarization.Arc",
                     {"train": [_port_file(f) for f in train]}))


def _rel(ours, theirs):
    return float(np.linalg.norm(ours - theirs) / np.linalg.norm(theirs))


@pytest.mark.parametrize("margin,scale", [(28.6, 64.0), (10.0, 30.0)])
def test_arcface_loss_and_gradient_match_jax(margin, scale):
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((8, 16)).astype(np.float32)
    weights = rng.standard_normal((5, 16)).astype(np.float32)
    labels = rng.integers(0, 5, 8).astype(np.int32)
    emb[0] = weights[labels[0]] * 2.0           # one near the clip
    loss, (g_emb, g_w) = jax.value_and_grad(
        lambda e, w: jax_embedding.arcface_loss(
            e, jnp.asarray(labels), w, margin_deg=margin, scale=scale),
        argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(weights))
    e = torch.from_numpy(emb).requires_grad_()
    w = torch.from_numpy(weights).requires_grad_()
    ours = embedding.arcface_loss(e, torch.from_numpy(labels), w,
                                  margin_deg=margin, scale=scale)
    ours.backward()
    assert abs(float(ours.detach()) - float(loss)) <= \
        LOSS_RTOL * abs(float(loss))
    assert _rel(e.grad.numpy(), np.asarray(g_emb)) <= LOSS_RTOL
    assert _rel(w.grad.numpy(), np.asarray(g_w)) <= LOSS_RTOL


def _tasks(protocols, **kwargs):
    options = dict(TASK, **kwargs)
    jax_task = jax_embedding.SupervisedRepresentationLearningWithArcFace(
        protocols[0], **options)
    port_task = embedding.SupervisedRepresentationLearningWithArcFace(
        protocols[1], **options)
    jax_task.setup()
    port_task.setup()
    return jax_task, port_task


def test_arcface_batches_equal_jax(protocols):
    jax_task, port_task = _tasks(protocols)
    assert port_task.classes == jax_task.classes == \
        ["alice", "bob", "carol", "dave"]
    assert port_task.train__len__() == jax_task.train__len__()
    assert port_task.batch_size == 6
    durations = set()
    for epoch in (0, 1, 2):
        ours = list(port_task.train_batches(epoch=epoch))
        theirs = list(jax_task.train_batches(epoch=epoch))
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.X, b.X)
            np.testing.assert_array_equal(a.y, b.y)
            assert a.y.dtype == np.int32
            durations.add(a.X.shape[-1])
    # durations on the 0.25 s grid, and some short turn zero-padded
    assert all(n % 4000 == 0 for n in durations) and len(durations) > 1
    assert port_task.prepare_validation() == []
    assert [type(m) for m in port_task.default_metric()] == \
        [EqualErrorRate, BinnedAUROC]
    assert embedding.SupervisedRepresentationLearningTaskMixin is \
        embedding.SupervisedRepresentationLearningWithArcFace


class SmallResNet(jax_wespeaker.BaseWeSpeakerResNet):
    """ResNet (1, 1, 1, 1) x 8 with a float32 trunk."""

    NUM_BLOCKS = (1, 1, 1, 1)

    def build_module(self):
        return jax_wespeaker.WeSpeakerModule(
            num_blocks=(1, 1, 1, 1), m_channels=8,
            compute_dtype=jnp.float32)


def _models(kind, jax_task, seed=0):
    if kind == "debug":
        model = JaxSimpleEmbeddingModel(task=jax_task)
        model.build(jax.random.PRNGKey(seed))
        port = SimpleEmbeddingModel().load_reference_state_dict(
            debug_embedding_state_dict(model.params))
    else:
        model = SmallResNet(task=jax_task)
        model.build(jax.random.PRNGKey(seed))
        model.params = perturb(jax.tree_util.tree_map(np.asarray,
                                                      model.params),
                               np.random.default_rng(seed))
        port = wespeaker.WeSpeakerResNet34(
            num_blocks=(1, 1, 1, 1), m_channels=8,
            compute_dtype=torch.float32).load_reference_state_dict(
                wespeaker_state_dict(model.params))
    return model, port


def _state_of(kind, params):
    return debug_embedding_state_dict(params) if kind == "debug" \
        else wespeaker_state_dict(params)


@pytest.mark.parametrize("kind", ["debug", "resnet"])
def test_trainer_steps_match_jax(protocols, kind):
    jax_task, port_task = _tasks(protocols)
    model, port = _models(kind, jax_task)
    port_task.setup(port)
    params = jax_task.augment_params(model.params, jax.random.PRNGKey(1),
                                     model)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    port_task.trainable_params = {"arcface": torch.nn.Parameter(
        torch.tensor(arcface_prototypes(jax.tree_util.tree_map(
            np.asarray, params))))}
    tx = optax.adam(LR)
    step = make_train_step(jax_task, model, tx,
                           frozen_prefixes=("batch_stats",))
    opt_state = tx.init(params)
    trainer = Trainer(device="cpu", learning_rate=LR)
    names = [n for n, _ in port.named_parameters()] + ["task.arcface"]
    port_params = list(port.parameters()) + [port_task.arcface]
    optimizer = trainer.make_optimizer(port_params, names)
    stats = {n: b.clone() for n, b in port.named_buffers()}
    jax_stats = jax.tree_util.tree_map(np.asarray,
                                       params.get("batch_stats", {}))
    train_mode(port)
    batches = [next(iter(jax_task.train_batches(epoch=e))) for e in range(3)]
    for batch in batches:
        params, opt_state, jloss = step(params, opt_state,
                                        jnp.asarray(batch.X),
                                        jnp.asarray(batch.y), None, None)
        device_batch = trainer.to_device(batch)
        assert device_batch.y.dtype == torch.int32
        ploss = trainer.train_step(port, port_task, optimizer, port_params,
                                   [False] * len(port_params), device_batch)
        assert abs(float(ploss) - float(jloss)) <= \
            LOSS_RTOL * abs(float(jloss))
    params = jax.tree_util.tree_map(np.asarray, params)
    expected = _state_of(kind, params)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), expected[name],
                                   rtol=0, atol=2 * LR, err_msg=name)
    np.testing.assert_allclose(port_task.arcface.detach().numpy(),
                               params["arcface"], rtol=0, atol=2 * LR)
    for name, buffer in port.named_buffers():
        assert torch.equal(buffer, stats[name]), name
    for a, b in zip(jax.tree_util.tree_leaves(jax_stats),
                    jax.tree_util.tree_leaves(params.get("batch_stats",
                                                         {}))):
        np.testing.assert_array_equal(a, b)


def test_jax_trainer_steps_running_statistics_the_port_keeps(protocols):
    """At its defaults the JAX trainer differentiates and Adam-steps the
    ResNet's running statistics (by lr each, on the first step); the
    port's trainer leaves them where they were."""
    jax_task, port_task = _tasks(protocols)
    model, port = _models("resnet", jax_task, seed=2)
    params = jax_task.augment_params(model.params, jax.random.PRNGKey(1),
                                     model)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    before = np.asarray(params["batch_stats"]["trunk"]["bn1"]["mean"])
    tx = optax.adam(LR)
    batch = next(iter(jax_task.train_batches(epoch=0)))
    after, _, _ = make_train_step(jax_task, model, tx)(
        params, tx.init(params), jnp.asarray(batch.X), jnp.asarray(batch.y),
        None, None)
    moved = np.abs(np.asarray(after["batch_stats"]["trunk"]["bn1"]["mean"])
                   - before)
    np.testing.assert_allclose(moved, LR, rtol=1e-3)
    port_task.setup(port)
    trainer = Trainer(device="cpu", max_epochs=1, limit_train_batches=1)
    stats = {n: b.clone() for n, b in port.named_buffers()}
    trainer.fit(port, port_task)
    for name, buffer in port.named_buffers():
        assert torch.equal(buffer, stats[name]), name


class _JaxTrials(JaxProtocol):
    def test_trial(self):
        return iter(self.trials)


class _Trials(Protocol):
    def test_trial(self):
        return iter(self.trials)


def test_verification_main_matches_jax(tmp_path, capsys):
    files = []
    for who, name in enumerate(("alice", "bob", "carol")):
        for k in range(3):
            f = make_file(tmp_path / f"{name}{k}.wav", [(name, 0.1, 1.9)],
                          duration=2.0, seed=20 + 3 * who + k)
            files.append(({"uri": f["uri"], "audio": f["audio"]}, who))
    trials = [{"file1": a, "file2": b, "reference": int(wa == wb)}
              for i, (a, wa) in enumerate(files)
              for b, wb in files[i + 1:]]
    model = JaxSimpleEmbeddingModel()
    model.build(jax.random.PRNGKey(3))
    port = SimpleEmbeddingModel().load_reference_state_dict(
        debug_embedding_state_dict(model.params)).eval()
    theirs, ours = _JaxTrials("T"), _Trials("T")
    theirs.trials = ours.trials = trials
    jax_eer = jax_verification.main(theirs, embedding=model)
    eer = speaker_verification.main(ours, embedding=port, device="cpu")
    assert abs(eer - jax_eer) <= EER_ATOL
    assert "EER = " in capsys.readouterr().out
    with pytest.raises(ValueError, match="development_trial"):
        speaker_verification.main(ours, subset="development",
                                  embedding=port, device="cpu")


@pytest.mark.parametrize("prefix", ["", "resnet."])
def test_convert_wespeaker_checkpoint(tmp_path, monkeypatch, prefix):
    jax_model, port = _models("resnet", None, seed=4)
    state = wespeaker_state_dict(jax_model.params)
    upstream = {k[len("resnet."):] if not prefix else k: torch.tensor(v)
                for k, v in state.items()}
    upstream["projection.weight"] = torch.zeros(3, 256)   # a head: dropped
    torch.save({"state_dict": upstream} if prefix else upstream,
               tmp_path / "avg_model.pt")
    convert.convert(str(tmp_path / "avg_model.pt"), str(tmp_path / "port"),
                    "WeSpeakerResNet34", num_blocks=(1, 1, 1, 1),
                    m_channels=8, compute_dtype=torch.float32)
    loaded = Model.from_pretrained(tmp_path / "port")
    assert type(loaded) is wespeaker.WeSpeakerResNet34
    for key, value in loaded.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[key], key)
    monkeypatch.setattr(jax_wespeaker, "SmallResNet", SmallResNet,
                        raising=False)
    jax_convert.convert(str(tmp_path / "avg_model.pt"),
                        str(tmp_path / "jax"), "SmallResNet")
    theirs = JaxModel.from_pretrained(str(tmp_path / "jax"))
    wav = np.random.default_rng(5).uniform(-0.3, 0.3, (2, 1, 32000)).astype(
        np.float32)
    with torch.no_grad():
        ours = loaded(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(ours, np.asarray(theirs(wav)), rtol=0,
                               atol=EMBEDDING_ATOL)
    with pytest.raises(ValueError, match="lacks"):
        torch.save({"conv1.weight": torch.zeros(8, 1, 3, 3)},
                   tmp_path / "bad.pt")
        convert.convert(str(tmp_path / "bad.pt"), str(tmp_path / "bad"))
