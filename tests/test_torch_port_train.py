"""Training on the port against the JAX package's, on the CPU.

The protocol is the synthetic corpus of ``corpus.py`` (harmonic speakers
with annotated turns, overlap included), built once with each package's
own annotation classes. Tolerances:

- batches: ``train_batches`` / ``train_batches_parallel`` (2 workers), the
  warm ``prepare_data`` cache and ``balance`` give X, y and weight equal
  to the JAX package's for the same seed;
- one step of PyanNet (H = 16, 2 s chunks, the JAX LSTM through its
  float32 scan): the loss within 1e-5; each gradient within 1e-4 relative
  L2, against the larger of its own norm and 1e-6 of the whole gradient's
  (the SincNet conv biases before an instance norm have a true gradient
  of zero, of which both packages give rounding noise); SincNet's within
  5e-2 (measured up to 2.6e-2, at the filter edges ``band_hz_``);
- the same step with both packages in float64: every gradient within
  1e-9 (measured up to 1.8e-11). So the float32 gap at the filter edges
  is rounding, not a different gradient: their gradient is a sum over
  the 251 taps that cancels (by a median 177x, up to 1e5x) of terms from
  float32 sines of arguments up to 392 rad (rounded by up to 1.5e-5 rad),
  and each package's float32 edge gradients lie 1.6e-2 to 5.3e-2 from
  the float64 value;
  after 3 Adam steps (lr 1e-3): every parameter within 6e-3 absolute, the
  most two Adam trajectories can part in 3 steps (a component whose
  gradient is rounding noise moves by up to lr either way; measured up to
  2.6e-3 in SincNet's convolutions, 8.1e-5 elsewhere), each update
  outside SincNet within 5e-3 relative L2 of the JAX package's (measured
  up to 8.7e-4) and the whole model's update within 5e-2 (measured
  1.25e-2); frozen parameters unchanged. The same with warm-up, a frame
  weight, weigh_by_cardinality, a frozen prefix and gradient clipping;
- validation: ``der/val``, its components and ``der/val/optimal`` within
  1e-6 of the JAX ``Trainer.validate``'s on the same weights, ``loss/val``
  within 1e-5;
- the trainer's own behaviour (the non-finite skip, ``resume_from``,
  early stopping, ``GraduallyUnfreeze``, the head swap): exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pyannote_audio_tpu.core.segment import (SlidingWindow as JaxWindow,
                                             SlidingWindowFeature as JaxSWF)
from pyannote_audio_tpu.core.task import TrainingBatch as JaxBatch
from pyannote_audio_tpu.models.blocks import sincnet as jax_sincnet
from pyannote_audio_tpu.models.segmentation.pyannet import \
    PyanNet as JaxPyanNet
from pyannote_audio_tpu.tasks import segmentation as jax_tasks
from pyannote_audio_tpu.train.trainer import Trainer as JaxTrainer
from pyannote_audio_tpu.train.trainer import make_train_step
from pyannote_audio_tpu.utils.database import Protocol as JaxProtocol
from pyannote_audio_tpu_torch.core.annotation import Annotation, Timeline
from pyannote_audio_tpu_torch.core.callback import GraduallyUnfreeze
from pyannote_audio_tpu_torch.core.model import (Model,
                                                 attach_specifications,
                                                 is_frozen)
from pyannote_audio_tpu_torch.core.segment import (Segment, SlidingWindow,
                                                   SlidingWindowFeature)
from pyannote_audio_tpu_torch.core.task import TrainingBatch
from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
from pyannote_audio_tpu_torch.tasks import segmentation as tasks
from pyannote_audio_tpu_torch.train import Trainer
from pyannote_audio_tpu_torch.train.trainer import TRAIN_STATE
from pyannote_audio_tpu_torch.utils import convert
from pyannote_audio_tpu_torch.utils.convert import pyannet_state_dict
from pyannote_audio_tpu_torch.utils.database import (Protocol,
                                                     get_protocol,
                                                     register_database)
from pyannote_audio_tpu_torch.utils.protocol import (
    FilterByNumberOfSpeakers, check_protocol)

from corpus import default_two_speaker_file, make_file

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SINC_GRAD_RTOL = 5e-2
F64_GRAD_RTOL = 1e-9
ADAM_ATOL = 6e-3
UPDATE_RTOL = 5e-3
MODEL_UPDATE_RTOL = 5e-2
DER_ATOL = 1e-6
HIDDEN = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for this module: its steps are many small ops,
    which slow down many times over when the test workers' thread pools
    share the cores; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_file(file):
    """A JAX corpus file dict with the port's annotation classes."""
    annotation = Annotation(uri=file["uri"])
    for seg, track, label in file["annotation"].itertracks(
            yield_label=True):
        annotation[Segment(seg.start, seg.end), track] = label
    out = dict(file, annotation=annotation, annotated=Timeline(
        [Segment(s.start, s.end) for s in file["annotated"]],
        uri=file["uri"]))
    if "loss_w" in file:
        w = file["loss_w"]
        out["loss_w"] = SlidingWindowFeature(w.data, SlidingWindow(
            duration=w.sliding_window.duration,
            step=w.sliding_window.step, start=w.sliding_window.start))
    return out


@pytest.fixture(scope="module")
def protocols(tmp_path_factory):
    """(JAX protocol, port protocol) over the same files."""
    root = tmp_path_factory.mktemp("port_train_corpus")
    train = [
        default_two_speaker_file(root / "trn00.wav"),
        make_file(root / "trn01.wav",
                  [("carol", 0.5, 4.0), ("dave", 5.0, 9.5),
                   ("carol", 10.0, 14.0)], duration=15.0, seed=1),
        # overlap and 4 speakers in one chunk
        make_file(root / "trn02.wav",
                  [("alice", 0.2, 3.5), ("bob", 1.5, 5.0),
                   ("carol", 1.8, 2.9), ("dave", 2.2, 6.0),
                   ("bob", 7.0, 11.5)], duration=12.0, seed=4),
    ]
    rng = np.random.default_rng(0)
    for file, database in zip(train, ("A", "B", "B")):
        file["database"] = database
    for file in train[:2]:
        duration = file["annotated"].extent().end
        file["loss_w"] = JaxSWF(
            rng.uniform(0.2, 1.0, (int(duration * 100), 1)).astype(
                np.float32), JaxWindow(duration=0.005, step=0.01))
    dev = [make_file(root / "dev00.wav",
                     [("alice", 1.0, 4.0), ("bob", 3.5, 9.0)],
                     duration=10.0, seed=2)]
    name = "Debug.SpeakerDiarization.Debug"
    return (JaxProtocol(name, {"train": train, "development": dev}),
            Protocol(name, {"train": [_port_file(f) for f in train],
                            "development": [_port_file(f) for f in dev]}))


def _jax_model(task, seed=0):
    model = JaxPyanNet(lstm={"hidden_size": HIDDEN},
                       linear={"hidden_size": HIDDEN}, task=task)
    task.setup(model)
    model.build(jax.random.PRNGKey(seed))
    return model


def _port_model_from(jax_model, port_task):
    model = PyanNet(lstm_hidden=HIDDEN, linear_hidden=HIDDEN)
    port_task.setup(model)
    attach_specifications(model, port_task.specifications)
    return model.load_reference_state_dict(pyannet_state_dict(
        jax.tree_util.tree_map(np.asarray, jax_model.params),
        jax_model.hparams))


def _pair(protocols, name, **kwargs):
    jax_task = getattr(jax_tasks, name)(protocols[0], **kwargs)
    port_task = getattr(tasks, name)(protocols[1], **kwargs)
    jax_model = _jax_model(jax_task)
    return jax_task, jax_model, port_task, _port_model_from(jax_model,
                                                            port_task)


def _assert_batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.X, b.X)
        np.testing.assert_array_equal(a.y, b.y)
        if b.weight is None:
            assert a.weight is None
        else:
            np.testing.assert_array_equal(a.weight, b.weight)


# -- protocols ----------------------------------------------------------------

def test_protocol_from_files_and_database_yml(protocols, tmp_path):
    port = protocols[1]
    files = list(port.train())
    with open(tmp_path / "all.rttm", "w") as f:
        for file in files:
            file["annotation"].write_rttm(f)
    (tmp_path / "all.uem").write_text("".join(
        f"{file['uri']} 1 0.000 {file['annotated'].extent().end:.3f}\n"
        for file in files))
    (tmp_path / "train.lst").write_text("trn00\ntrn02\n")
    (tmp_path / "database.yml").write_text(
        f"Databases:\n  Debug: {Path(files[0]['audio']).parent}/{{uri}}.wav\n"
        "Protocols:\n  Debug:\n    SpeakerDiarization:\n      Yml:\n"
        "        train:\n          uri: train.lst\n"
        "          annotation: all.rttm\n          annotated: all.uem\n"
        "        development:\n          annotation: all.rttm\n")
    register_database(tmp_path / "database.yml")
    protocol = get_protocol("Debug.SpeakerDiarization.Yml")
    train = list(protocol.train())
    assert [f["uri"] for f in train] == ["trn00", "trn02"]
    assert train[0]["audio"] == files[0]["audio"]
    assert train[0]["annotated"].extent() == Segment(0.0, 30.0)
    assert len(list(protocol.development())) == 3
    # without a UEM the annotated region is the annotation's extent
    dev = {f["uri"]: f for f in protocol.development()}
    assert dev["trn01"]["annotated"].extent() == Segment(0.5, 14.0)
    checked, has_dev = check_protocol(protocol)
    assert has_dev and checked is protocol
    merged = Protocol.from_files("X", tmp_path / "all.rttm").merged_with(
        Protocol.from_files("X", tmp_path / "all.rttm", subset="test"))
    assert len(list(merged.files())) == 6
    with pytest.raises(KeyError):
        get_protocol("Debug.SpeakerDiarization.Missing")
    two = FilterByNumberOfSpeakers(2)(files[2])
    assert two.labels() == ["bob", "dave"]     # the two most talkative


# -- batches ------------------------------------------------------------------

@pytest.mark.parametrize("name,kwargs", [
    ("SpeakerDiarization", {"weight": "loss_w", "max_speakers_per_chunk": 3}),
    ("SpeakerDiarization", {}),
    ("VoiceActivityDetection", {"weight": "loss_w"}),
    ("MultiLabelSegmentation", {}),
    ("SpeakerDiarization", {"balance": ["database"]}),
])
def test_train_batches_equal_jax(protocols, name, kwargs):
    jax_task = getattr(jax_tasks, name)(protocols[0], duration=2.0,
                                        batch_size=4, seed=3, **kwargs)
    port_task = getattr(tasks, name)(protocols[1], duration=2.0,
                                     batch_size=4, seed=3, **kwargs)
    jax_task.setup(JaxPyanNet())
    port_task.setup(PyanNet(lstm_hidden=8, linear_hidden=8))
    assert port_task.specifications.classes == \
        jax_task.specifications.classes
    for epoch in (0, 1):
        _assert_batches_equal(port_task.train_batches(epoch=epoch),
                              jax_task.train_batches(epoch=epoch))


def test_parallel_batches_and_cache_equal_jax(protocols, tmp_path):
    jax_task = jax_tasks.SpeakerDiarization(
        protocols[0], duration=2.0, batch_size=4, seed=5, num_workers=2)
    jax_task.setup(JaxPyanNet())
    cache = tmp_path / "prepared.npz"
    port_task = tasks.SpeakerDiarization(
        protocols[1], duration=2.0, batch_size=4, seed=5, num_workers=2,
        cache=str(cache))
    port_task.setup(PyanNet(lstm_hidden=8, linear_hidden=8))
    assert cache.exists()
    expected = list(jax_task.train_batches_parallel(epoch=0))
    _assert_batches_equal(port_task.train_batches_parallel(epoch=0),
                          expected)

    class PoisonProtocol:
        name = protocols[1].name

        def train(self):
            raise RuntimeError("protocol scanned despite a warm cache")

        development = train

    warm = tasks.SpeakerDiarization(PoisonProtocol(), duration=2.0,
                                    batch_size=4, seed=5, num_workers=2,
                                    cache=str(cache))
    warm.setup(PyanNet(lstm_hidden=8, linear_hidden=8))
    _assert_batches_equal(warm.train_batches_parallel(epoch=0), expected)
    assert warm.prepare_validation() == [] or len(
        warm.prepare_validation()) == len(jax_task.prepare_validation())

    def boom(*args, **kwargs):
        raise RuntimeError("corrupt training file")

    port_task.prepare_chunk = boom
    with pytest.raises(RuntimeError, match="corrupt training file"):
        list(port_task.train_batches_parallel(epoch=0))


def test_chunk_weight_frames_do_not_follow_chunk_rounding(protocols):
    """Frames of 10 ms at a 10 ms step: ``end - start`` of a chunk rounds
    below 2 s for some starts, which costs the JAX package a frame (its
    batches then fail to stack); the port crops the task's 2 s."""
    task = tasks.VoiceActivityDetection(protocols[1], weight="w")
    file = {"w": SlidingWindowFeature(np.ones((3000, 1), np.float32),
                                      SlidingWindow(0.01, 0.01))}
    shapes = {task.chunk_weight(file, Segment(s, s + 2.0)).shape
              for s in np.linspace(0.0, 27.0, 500)}
    assert shapes == {(200, 1)}


def test_chunk_weight_of_a_whole_file_array_equals_jax(protocols):
    weights = np.random.default_rng(1).uniform(size=1500).astype(
        np.float32)
    jax_task = jax_tasks.VoiceActivityDetection(protocols[0],
                                                weight="loss_w")
    port_task = tasks.VoiceActivityDetection(protocols[1], weight="loss_w")
    jax_file = dict(next(protocols[0].train()), loss_w=weights,
                    duration=15.0)
    port_file = dict(next(protocols[1].train()), loss_w=weights,
                     duration=15.0)
    for start in (0.0, 3.33, 13.5):
        ours = port_task.chunk_weight(port_file,
                                      Segment(start, start + 2.0))
        theirs = jax_task.chunk_weight(
            jax_file, type(jax_file["annotated"].extent())(start,
                                                           start + 2.0))
        np.testing.assert_array_equal(ours, theirs)


# -- one training step ----------------------------------------------------------

def _rel_l2(ours, theirs, floor):
    return np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs),
                                               floor)


STEP_CASES = {
    "plain": ({}, {}),
    "options": ({"warm_up": 0.2, "weight": "loss_w",
                 "weigh_by_cardinality": True},
                {"frozen": ("sincnet",), "clip": 0.05}),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_training_step_matches_jax(protocols, case):
    task_kwargs, trainer_kwargs = STEP_CASES[case]
    jax_task, jax_model, port_task, port_model = _pair(
        protocols, "SpeakerDiarization", duration=2.0, batch_size=4,
        seed=11, max_speakers_per_chunk=3, **task_kwargs)
    batches = [b for b in jax_task.train_batches(epoch=0)
               if b.weight is not None or not task_kwargs][:3]
    assert len(batches) == 3

    def jax_loss(params, batch):
        return jax_task.loss(jax_model, params, JaxBatch(
            X=jnp.asarray(batch.X), y=jnp.asarray(batch.y),
            weight=None if batch.weight is None
            else jnp.asarray(batch.weight)))

    params = jax_model.params
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, batches[0])))(params)
    trainer = Trainer(device="cpu", learning_rate=1e-3,
                      gradient_clip_val=trainer_kwargs.get("clip"))
    batch = trainer.to_device(batches[0])
    ours = port_task.loss(port_model, batch)
    ours.backward()
    assert abs(float(ours.detach()) - float(loss)) <= \
        LOSS_RTOL * abs(float(loss))
    expected = pyannet_state_dict(jax.tree_util.tree_map(np.asarray, grads),
                                  jax_model.hparams)
    floor = 1e-6 * np.sqrt(sum(np.sum(g ** 2) for g in expected.values()))
    for name, p in port_model.named_parameters():
        rtol = SINC_GRAD_RTOL if name.startswith("sincnet.") else GRAD_RTOL
        assert _rel_l2(p.grad.numpy(), expected[name], floor) <= rtol, name
    # the LSTM and SincNet weights receive gradient
    assert port_model.lstm.weight_hh_l0.grad.abs().max() > 0
    assert port_model.sincnet.conv1d[1].weight.grad.abs().max() > 0

    # three optimizer steps on each side
    frozen = trainer_kwargs.get("frozen", ())
    tx = optax.adam(1e-3)
    if trainer_kwargs.get("clip"):
        tx = optax.chain(optax.clip_by_global_norm(trainer_kwargs["clip"]),
                         tx)
    step = make_train_step(jax_task, jax_model, tx, frozen_prefixes=frozen)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    opt_state = tx.init(jparams)
    names = [n for n, _ in port_model.named_parameters()]
    port_params = list(port_model.parameters())
    optimizer = trainer.make_optimizer(port_params)
    mask = [is_frozen(n, frozen) for n in names]
    before = {n: p.detach().clone() for n, p in port_model.named_parameters()}
    for b in batches:
        jparams, opt_state, jloss = step(
            jparams, opt_state, jnp.asarray(b.X), jnp.asarray(b.y),
            None if b.weight is None else jnp.asarray(b.weight), None)
        ploss = trainer.train_step(port_model, port_task, optimizer,
                                   port_params, mask, trainer.to_device(b))
        assert abs(float(ploss) - float(jloss)) <= LOSS_RTOL * abs(
            float(jloss))
    expected = pyannet_state_dict(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  jax_model.hparams)
    ours_updates, updates = [], []
    for name, p in port_model.named_parameters():
        ours_p = p.detach().numpy()
        update = expected[name] - before[name].numpy()
        ours_updates.append(ours_p - before[name].numpy())
        updates.append(update)
        np.testing.assert_allclose(ours_p, expected[name],
                                   atol=ADAM_ATOL, err_msg=name)
        if not name.startswith("sincnet."):
            assert _rel_l2(ours_p - before[name].numpy(), update,
                           1e-12) <= UPDATE_RTOL, name
        if any(m and n == name for n, m in zip(names, mask)):
            assert torch.equal(p.detach(), before[name]), name
    assert _rel_l2(np.concatenate([u.ravel() for u in ours_updates]),
                   np.concatenate([u.ravel() for u in updates]),
                   1e-12) <= MODEL_UPDATE_RTOL


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX SincNet
    pins its dtype through its module's ``jnp.float32``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_training_gradients_match_jax_in_float64(protocols, monkeypatch):
    """The plain case of test_training_step_matches_jax with both packages
    in float64 (the same float32 weights and batch): the port's SincNet
    gradient is the JAX package's, and SINC_GRAD_RTOL only covers
    float32 rounding."""
    jax_task, jax_model, port_task, port_model = _pair(
        protocols, "SpeakerDiarization", duration=2.0, batch_size=4,
        seed=11, max_speakers_per_chunk=3)
    batch = next(iter(jax_task.train_batches(epoch=0)))
    monkeypatch.setattr(jax_sincnet, "jnp", _Float64Numpy())
    monkeypatch.setattr(convert, "_f32",
                        lambda a: np.asarray(a, np.float64))
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64),
            jax_model.params)

        def loss(p):
            return jax_task.loss(jax_model, p, JaxBatch(
                X=jnp.asarray(batch.X, jnp.float64), y=jnp.asarray(batch.y)))

        grads = jax.jit(jax.grad(loss))(params)
        expected = pyannet_state_dict(
            jax.tree_util.tree_map(np.asarray, grads), jax_model.hparams)
    port_model.double()
    port_task.loss(port_model, TrainingBatch(
        X=torch.from_numpy(batch.X.astype(np.float64)),
        y=torch.from_numpy(batch.y.astype(np.float32)))).backward()
    floor = 1e-6 * np.sqrt(sum(np.sum(g ** 2) for g in expected.values()))
    for name, p in port_model.named_parameters():
        assert p.grad.dtype == torch.float64, name
        assert _rel_l2(p.grad.numpy(), expected[name], floor) <= \
            F64_GRAD_RTOL, name


def test_validation_matches_jax(protocols):
    jax_task, jax_model, port_task, port_model = _pair(
        protocols, "SpeakerDiarization", duration=2.0, batch_size=4,
        seed=2, max_speakers_per_chunk=3)
    theirs = JaxTrainer().validate(jax_model, jax_task, jax_model.params,
                                   eval_batch_size=4)
    ours = Trainer(device="cpu").validate(port_model, port_task,
                                          eval_batch_size=4)
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        atol = LOSS_RTOL if key == "loss/val" else DER_ATOL
        assert ours[key] == pytest.approx(value, abs=atol), key
    assert "der/val/optimal_threshold" in ours


# -- the trainer's own behaviour ------------------------------------------------

def _small(protocol, seed=0, **kwargs):
    task = tasks.SpeakerDiarization(protocol, duration=2.0, batch_size=2,
                                    seed=seed, max_speakers_per_chunk=3,
                                    **kwargs)
    model = PyanNet(lstm_hidden=8, lstm_layers=1, linear_hidden=8,
                    generator=torch.Generator().manual_seed(seed))
    return task, model


def _snapshot(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_non_finite_loss_leaves_params_and_state(protocols):
    task, model = _small(protocols[1])
    trainer = Trainer(device="cpu")
    task.setup(model)
    attach_specifications(model, task.specifications)
    params = list(model.parameters())
    optimizer = trainer.make_optimizer(params)
    batches = task.train_batches(epoch=0)
    good = trainer.to_device(next(batches))
    frozen = [False] * len(params)
    bad = TrainingBatch(X=good.X * float("nan"), y=good.y)
    start = _snapshot(model)
    # a skip before any state: the state the step made is Adam's initial
    assert not torch.isfinite(trainer.train_step(model, task, optimizer,
                                                 params, frozen, bad))
    for name, p in model.named_parameters():
        assert torch.equal(p, start[name]), name
    for s in optimizer.state.values():
        assert float(s["step"]) == 0 and not s["exp_avg"].any() \
            and not s["exp_avg_sq"].any()
    trainer.train_step(model, task, optimizer, params, frozen, good)
    state = {k: {n: t.clone() for n, t in v.items()}
             for k, v in optimizer.state.items()}
    params_before = _snapshot(model)
    assert not torch.isfinite(trainer.train_step(model, task, optimizer,
                                                 params, frozen, bad))
    for name, p in model.named_parameters():
        assert torch.equal(p, params_before[name]), name
    for p, s in optimizer.state.items():
        assert float(s["step"]) == 1
        for key, value in s.items():
            assert torch.equal(value, state[p][key]), key
    # the epoch's warning names the skipped batch
    task.loss_from_output = lambda out, batch: out.sum() * float("nan")
    with pytest.warns(UserWarning, match=r"skipped 1 batch\(es\)"):
        Trainer(device="cpu", max_epochs=1, limit_train_batches=1).fit(
            model, task)


def test_resume_continues_exactly(protocols, tmp_path):
    task, model = _small(protocols[1], seed=1)
    Trainer(device="cpu", max_epochs=2, limit_train_batches=2).fit(model,
                                                                   task)
    task1, model1 = _small(protocols[1], seed=1)
    Trainer(device="cpu", max_epochs=1, limit_train_batches=2,
            checkpoint_dir=tmp_path).fit(model1, task1)
    assert (tmp_path / "epoch_0" / TRAIN_STATE).exists()
    task2, model2 = _small(protocols[1], seed=1)
    resumed = Trainer(device="cpu", max_epochs=2, limit_train_batches=2)
    resumed.fit(model2, task2, resume_from=tmp_path / "epoch_0")
    assert [h["epoch"] for h in resumed.history] == [1]
    for (name, a), b in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(a, b), name


def test_early_stopping_and_best_checkpoint(protocols, tmp_path):
    task, model = _small(protocols[1], seed=5)
    trainer = Trainer(device="cpu", max_epochs=50, limit_train_batches=1,
                      learning_rate=0.0, checkpoint_dir=tmp_path,
                      log_dir=tmp_path / "logs", limit_val_chunks=2,
                      monitor=("loss/val", "min"), early_stopping_patience=2)
    trainer.fit(model, task)
    # with no learning the validation loss repeats: epoch 0 sets the best,
    # epochs 1 and 2 do not improve
    assert len(trainer.history) == 3 and trainer.best_epoch == 0
    assert len((tmp_path / "logs" / "metrics.jsonl").read_text()
               .splitlines()) == 3
    assert (tmp_path / "logs" / "samples_epoch0.png").exists()
    loaded = Model.from_pretrained(tmp_path / "best")
    x = torch.randn(2, 1, 32000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(loaded(x), model(x))
    # the validation monitor, in max direction
    monitored = Trainer(device="cpu", max_epochs=2, limit_train_batches=1,
                        limit_val_chunks=2, monitor=("der/val/recall", "max"))
    monitored.fit(model, task)
    assert monitored.best_epoch in (0, 1)


def test_gradually_unfreeze(protocols):
    task, model = _small(protocols[1], seed=6)
    start = _snapshot(model)
    trainer = Trainer(device="cpu", max_epochs=1, limit_train_batches=1,
                      callbacks=[GraduallyUnfreeze()])
    trainer.fit(model, task)
    assert trainer.frozen_prefixes == ["linear", "lstm", "sincnet"]
    after0 = _snapshot(model)
    for name in start:
        moved = not torch.equal(start[name], after0[name])
        assert moved == name.startswith("classifier"), name
    trainer = Trainer(device="cpu", max_epochs=2, limit_train_batches=1,
                      callbacks=[GraduallyUnfreeze()])
    task, model = _small(protocols[1], seed=6)
    trainer.fit(model, task)
    assert trainer.frozen_prefixes == ["lstm", "sincnet"]
    after1 = _snapshot(model)
    for name in start:
        moved = not torch.equal(start[name], after1[name])
        assert moved == name.startswith(("classifier", "linear")), name
    # the model's own freezing seeds the trainer's prefixes
    task, model = _small(protocols[1], seed=6)
    model.freeze_up_to("lstm")
    assert model.frozen_modules == ["sincnet", "lstm"]
    Trainer(device="cpu", max_epochs=1, limit_train_batches=1).fit(model,
                                                                  task)
    assert torch.equal(model.lstm.weight_hh_l0, start["lstm.weight_hh_l0"])
    model.unfreeze_by_name("sincnet")
    assert model.frozen_modules == ["lstm"]
    with pytest.raises(ValueError, match="Could not find"):
        model.freeze_by_name("nothing")


def test_head_swap_keeps_the_other_weights(protocols):
    vad = tasks.VoiceActivityDetection(protocols[1], duration=2.0,
                                       batch_size=2)
    model = PyanNet(lstm_hidden=8, linear_hidden=8)
    Trainer(device="cpu", max_epochs=1, limit_train_batches=1).fit(model,
                                                                   vad)
    assert model.classifier.out_features == 1
    trunk = {n: p.detach().clone() for n, p in model.named_parameters()
             if not n.startswith("classifier")}
    diarization, _ = _small(protocols[1])
    diarization.setup(model)
    attach_specifications(model, diarization.specifications)
    assert model.classifier.out_features == 7
    for name, p in model.named_parameters():
        if name in trunk:
            assert torch.equal(p, trunk[name]), name
    Trainer(device="cpu", max_epochs=1, limit_train_batches=1).fit(
        model, diarization)
    assert model(torch.zeros(1, 1, 32000)).shape[-1] == 7


def test_trainer_devices_and_mesh():
    with pytest.raises(NotImplementedError, match="DDP"):
        Trainer(device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            Trainer()


@pytest.mark.cuda
def test_training_step_reaches_the_lstm_and_sincnet_on_card(protocols):
    """On a card the forward launches the LSTM kernel (once per layer)
    and the backward gives the BiLSTM and SincNet gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LSTM kernel has no CPU mode")
    from pyannote_audio_tpu_torch.ops import lstm_kernel
    task, model = _small(protocols[1])
    task.setup(model)
    attach_specifications(model, task.specifications)
    model.cuda()
    trainer = Trainer(device="cuda")
    batch = trainer.to_device(next(task.train_batches(epoch=0)))
    before = lstm_kernel.lstm_bidirectional_recurrence.launches
    task.loss(model, batch).backward()
    assert lstm_kernel.lstm_bidirectional_recurrence.launches == before + 2
    assert model.lstm.weight_hh_l0.grad.abs().max() > 0
    assert model.sincnet.conv1d[1].weight.grad.abs().max() > 0


def test_evaluate_matches_jax(protocols, capsys):
    """Frame-level DER of an aggregated (VAD) output over the
    development subset."""
    jax_task, jax_model, port_task, port_model = _pair(
        protocols, "VoiceActivityDetection", duration=2.0, batch_size=4)
    ours = tasks.evaluate(protocols[1], subset="development",
                          model=port_model, device="cpu")
    assert "TOTAL DER" in capsys.readouterr().out
    theirs = jax_tasks.evaluate(protocols[0], subset="development",
                                model=jax_model, display=False)
    assert ours == pytest.approx(theirs, abs=DER_ATOL)


def test_registered_augmentation_reaches_the_batches(protocols):
    from pyannote_audio_tpu_torch.augmentation import (
        register_augmentation, unregister_augmentation)
    task = tasks.VoiceActivityDetection(protocols[1], duration=2.0,
                                        batch_size=2, seed=4)
    task.setup(PyanNet(lstm_hidden=8, linear_hidden=8))
    plain = next(task.train_batches(epoch=0))
    register_augmentation("halve", lambda X, y: (X * 0.5, y))
    try:
        halved = next(task.train_batches(epoch=0))
    finally:
        unregister_augmentation("halve")
    np.testing.assert_array_equal(halved.X, plain.X * 0.5)
    np.testing.assert_array_equal(halved.y, plain.y)


@pytest.mark.parametrize("name", ["VoiceActivityDetection",
                                  "MultiLabelSegmentation"])
def test_fit_other_tasks_and_reload(protocols, tmp_path, name):
    """VAD and multi-label tasks train too (``auroc/val`` in the record)
    and their checkpoints load through Model.from_pretrained."""
    task = getattr(tasks, name)(protocols[1], duration=2.0, batch_size=2,
                                seed=9)
    model = PyanNet(lstm_hidden=8, linear_hidden=8,
                    generator=torch.Generator().manual_seed(9))
    trainer = Trainer(device="cpu", max_epochs=1, limit_train_batches=2,
                      checkpoint_dir=tmp_path)
    trainer.fit(model, task)
    record = trainer.history[0]
    assert np.isfinite(record["loss"]) and "auroc/val" in record
    loaded = Model.from_pretrained(tmp_path / "epoch_0")
    assert loaded.specifications.problem == task.specifications.problem
    x = torch.randn(1, 1, 32000, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(loaded(x), model(x))
