"""PixIT (joint diarization and MixIT separation) on the port against the
JAX package.

ToTaToNet at a small size (16 filters, a DPRNN of 2 repeats x 32, chunk
50; a WavLM branch of 2 layers, 64 wide), its weights carried with
``utils/convert.py``. Tolerances: ``negative_sisdr`` and ``mixit_loss``
(weighted and unweighted) within 1e-5 relative; the device permutation's
indices equal to ``permutate_jax``'s (ties to the first permutation);
PixIT's batches (X, y, the MoM pairs and weights) and validation chunks
equal to the JAX task's from the same protocol and seed; the loss in its
training form (drawn MoMs), its validation form (the batch's even + odd
items) and on one item within 1e-4 relative; three ``Trainer`` steps
under ``pixit_optimizer`` against the JAX trainer's step from the same
weights: the loss within 1e-5 relative at the first step and 1e-4 at the
next two (Adam moves a component whose gradient is rounding noise by up
to lr either way), every parameter within 2 lr (1e-3) after 3 steps; one step of ``pixit_optimizer`` moves
WavLM's parameters by its rate and the rest by theirs, under one clip of
their joint norm, as the JAX optimizer; validation through the trainer
(``loss/val`` runs the MoM forward) as the JAX trainer's within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from corpus import make_file
from pyannote_audio_tpu.core.task import TrainingBatch as JaxBatch
from pyannote_audio_tpu.models.separation.totatonet import \
    ToTaToNet as JaxToTaToNet
from pyannote_audio_tpu.ops.permutation import permutate_jax
from pyannote_audio_tpu.tasks import separation as jax_separation
from pyannote_audio_tpu.train.trainer import Trainer as JaxTrainer
from pyannote_audio_tpu.train.trainer import make_train_step
from pyannote_audio_tpu.utils.database import Protocol as JaxProtocol
from pyannote_audio_tpu_torch.core.task import TrainingBatch
from pyannote_audio_tpu_torch.models.segmentation.sseriouss import SSeRiouSS
from pyannote_audio_tpu_torch.models.separation.totatonet import ToTaToNet
from pyannote_audio_tpu_torch.ops.permutation import permutate_device
from pyannote_audio_tpu_torch.tasks import separation
from pyannote_audio_tpu_torch.train import Trainer
from pyannote_audio_tpu_torch.utils.convert import totatonet_state_dict
from pyannote_audio_tpu_torch.utils.database import Protocol
from test_torch_port_models import perturb
from test_torch_port_train import _port_file
from test_torch_port_models import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-5
PIXIT_LOSS_RTOL = 1e-4
# the loss at Adam steps 2 and 3 (measured 7.8e-6 and 1.4e-5)
LATER_LOSS_RTOL = 1e-4
LR, WAVLM_LR, CLIP = 1e-3, 1e-5, 5.0
WAVLM = dict(hidden=64, layers=2, heads=4, ffn=128, conv_channels=16,
             rel_pos_bias=True, pre_ln=True, conv_norm="layer")
HPARAMS = dict(dprnn={"n_repeats": 2, "bn_chan": 32, "hid_size": 32,
                      "chunk_size": 50},
               encoder_decoder={"n_filters": 16},
               linear={"hidden_size": 16, "num_layers": 1})
TASK = dict(duration=2.0, batch_size=4, seed=7)


@pytest.fixture(scope="module")
def protocols(tmp_path_factory):
    """(JAX protocol, port protocol): two training files with
    single-speaker stretches of 2 s and more, overlap, and a development
    file."""
    root = tmp_path_factory.mktemp("pixit_corpus")
    train = [make_file(root / "p0.wav",
                       [("alice", 0.5, 4.0), ("bob", 4.5, 8.0),
                        ("alice", 8.5, 12.0), ("bob", 11.0, 15.0),
                        ("alice", 15.5, 19.5)], duration=20.0, seed=4),
             make_file(root / "p1.wav",
                       [("carol", 0.5, 4.0), ("dave", 3.0, 6.5),
                        ("alice", 6.6, 9.5), ("carol", 7.0, 7.5),
                        ("dave", 10.0, 13.5)], duration=14.0, seed=5)]
    dev = [make_file(root / "p2.wav",
                     [("alice", 0.5, 3.5), ("bob", 3.0, 7.5)],
                     duration=8.0, seed=6)]
    return (JaxProtocol("Debug.Separation.PixIT",
                        {"train": train, "development": dev}),
            Protocol("Debug.Separation.PixIT",
                     {"train": [_port_file(f) for f in train],
                      "development": [_port_file(f) for f in dev]}))


@pytest.fixture(scope="module")
def models():
    model = JaxToTaToNet(**HPARAMS, use_wavlm=True, wavlm_config=dict(WAVLM))
    model.build(jax.random.PRNGKey(3))
    model.params = perturb(jax.tree_util.tree_map(np.asarray, model.params),
                           np.random.default_rng(3))
    return model, _port_from(model.params)


def _port_from(params):
    port = ToTaToNet(**HPARAMS, use_wavlm=True, wavlm_config=dict(WAVLM))
    return port.load_reference_state_dict(totatonet_state_dict(
        params, {"dprnn": HPARAMS["dprnn"], "n_sources": 3,
                 "linear": HPARAMS["linear"]}, WAVLM["layers"]))


def _tasks(protocols, models, **kwargs):
    options = dict(TASK, **kwargs)
    jax_task = jax_separation.PixIT(protocols[0], **options)
    port_task = separation.PixIT(protocols[1], **options)
    jax_task.setup(models[0])
    port_task.setup(models[1])
    return jax_task, port_task


def _rel(ours, theirs):
    return abs(ours - theirs) / abs(theirs)


# -- losses and the permutation -------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_sisdr_and_mixit_loss_match_jax(weighted):
    rng = np.random.default_rng(0)
    est = rng.standard_normal((4, 800, 3)).astype(np.float32)
    mix1, mix2 = (rng.standard_normal((4, 800)).astype(np.float32)
                  for _ in range(2))
    weight = np.array([1.0, 0.0, 1.0, 1.0], np.float32) if weighted \
        else None
    np.testing.assert_array_equal(separation.mixit_partitions(3),
                                  jax_separation.mixit_partitions(3))
    sisdr = separation.negative_sisdr(torch.from_numpy(est[..., 0]),
                                      torch.from_numpy(mix1)).numpy()
    np.testing.assert_allclose(sisdr, np.asarray(
        jax_separation.negative_sisdr(jnp.asarray(est[..., 0]),
                                      jnp.asarray(mix1))), rtol=LOSS_RTOL)
    ours = separation.mixit_loss(
        torch.from_numpy(est), torch.from_numpy(mix1),
        torch.from_numpy(mix2),
        None if weight is None else torch.from_numpy(weight))
    theirs = jax_separation.mixit_loss(
        jnp.asarray(est), jnp.asarray(mix1), jnp.asarray(mix2),
        None if weight is None else jnp.asarray(weight))
    assert _rel(float(ours), float(theirs)) <= LOSS_RTOL


@pytest.mark.parametrize("K", [2, 3, 4])
def test_device_permutation_matches_permutate_jax(K):
    rng = np.random.default_rng(K)
    y1 = (rng.uniform(size=(6, 40, K)) > 0.5).astype(np.float32)
    y2 = rng.uniform(size=(6, 40, K)).astype(np.float32)
    y2[1, :, 1] = y2[1, :, 0]          # tied permutations: the first wins
    y2[2] = 0.5
    theirs, perm = permutate_jax(jnp.asarray(y1), jnp.asarray(y2))
    x = torch.from_numpy(y2).requires_grad_()
    ours, ours_perm = permutate_device(torch.from_numpy(y1), x)
    np.testing.assert_array_equal(ours_perm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(ours.detach().numpy(), np.asarray(theirs))
    ours.sum().backward()                # the gradient flows through
    np.testing.assert_array_equal(x.grad.numpy(), np.ones_like(y2))


# -- batches ----------------------------------------------------------------------

def test_pixit_batches_and_validation_chunks_equal_jax(protocols, models):
    jax_task, port_task = _tasks(protocols, models)
    assert port_task.specifications == tuple(
        type(port_task.specifications[0]).from_checkpoint(s.to_dict())
        for s in jax_task.specifications)
    assert port_task.val_monitor == jax_task.val_monitor
    assert sorted(port_task.default_metric()) == \
        sorted(jax_task.default_metric())
    drawn = 0
    for epoch in (0, 1):
        ours = list(port_task.train_batches(epoch=epoch))
        theirs = list(jax_task.train_batches(epoch=epoch))
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            for name in ("X", "y"):
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
            for key in ("mix1", "mix2", "mom_weight"):
                np.testing.assert_array_equal(a.meta[key], b.meta[key])
            drawn += int(a.meta["mom_weight"].sum())
    assert drawn > 0
    grid = port_task.prepare_validation()
    assert len(grid) == len(jax_task.prepare_validation()) > 0
    for (pf, chunk), (jf, jchunk), prepared in zip(
            grid, jax_task.prepare_validation(),
            separation.ValDataset(port_task)):
        theirs = jax_task.prepare_chunk(jf, jchunk,
                                        np.random.default_rng(0))
        for key in ("X", "y"):
            np.testing.assert_array_equal(prepared[key], theirs[key])
    # chunks longer than every single-speaker stretch: no MoM to draw
    jax_long, port_long = _tasks(protocols, models, duration=6.0)
    ours = next(iter(port_long.train_batches(epoch=0)))
    theirs = next(iter(jax_long.train_batches(epoch=0)))
    assert not ours.meta["mom_weight"].any()
    for key in ("mix1", "mix2", "mom_weight"):
        np.testing.assert_array_equal(ours.meta[key], theirs.meta[key])


# -- the loss -----------------------------------------------------------------------

@pytest.mark.parametrize("form", ["training", "validation", "one item"])
def test_pixit_loss_matches_jax(protocols, models, form):
    jax_task, port_task = _tasks(protocols, models)
    batch = next(iter(jax_task.train_batches(epoch=0)))
    meta = batch.meta
    X, y = batch.X, batch.y
    if form != "training":
        meta = None
        if form == "one item":
            X, y = X[:1], y[:1]
    model = models[0]
    theirs = jax.jit(lambda params, X, y, meta: jax_task.loss(
        model, params, JaxBatch(X=X, y=y, meta=meta)))(
            model.params, jnp.asarray(X), jnp.asarray(y),
            None if meta is None else {k: jnp.asarray(v)
                                       for k, v in meta.items()})
    port_batch = TrainingBatch(
        X=torch.from_numpy(X), y=torch.from_numpy(y),
        meta=None if meta is None else {k: torch.from_numpy(v)
                                        for k, v in meta.items()})
    with torch.no_grad():
        ours = port_task.loss(models[1], port_batch)
        if form == "validation":
            # the trainer's form: the validation forward's diarization,
            # then the within-batch MoM forward
            diarization, _ = models[1](port_batch.X)
            again = port_task.validation_loss(models[1], diarization,
                                              port_batch)
            assert float(again) == pytest.approx(float(ours), rel=1e-6)
    assert _rel(float(ours), float(theirs)) <= PIXIT_LOSS_RTOL


# -- training -----------------------------------------------------------------------

def test_trainer_steps_match_jax(protocols, models):
    jax_task, port_task = _tasks(protocols, models)
    model = models[0]
    port = _port_from(model.params)
    tx = jax_separation.pixit_optimizer(LR, WAVLM_LR, CLIP)
    step = make_train_step(jax_task, model, tx)
    params = jax.tree_util.tree_map(jnp.asarray, model.params)
    opt_state = tx.init(params)
    trainer = Trainer(device="cpu", optimizer=separation.pixit_optimizer(
        LR, WAVLM_LR, CLIP))
    names, port_params = zip(*port.named_parameters())
    optimizer = trainer.make_optimizer(list(port_params), list(names))
    batches = [next(iter(jax_task.train_batches(epoch=e))) for e in range(3)]
    for k, batch in enumerate(batches):
        params, opt_state, jloss = step(
            params, opt_state, jnp.asarray(batch.X), jnp.asarray(batch.y),
            None, {k: jnp.asarray(v) for k, v in batch.meta.items()})
        ploss = trainer.train_step(port, port_task, optimizer,
                                   list(port_params),
                                   [False] * len(port_params),
                                   trainer.to_device(batch))
        # from the second step on, the weights differ by what Adam made of
        # rounding-level gradient differences (a component with a noise
        # gradient moves by up to lr either way)
        assert _rel(float(ploss), float(jloss)) <= \
            (LOSS_RTOL if k == 0 else LATER_LOSS_RTOL)
    # the JAX parameters after 3 steps, in the port's layout
    expected = _port_from(jax.tree_util.tree_map(np.asarray, params))
    for name, value in expected.state_dict().items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(),
                                   value.numpy(), rtol=0, atol=2 * LR,
                                   err_msg=name)


def test_pixit_optimizer_routes_wavlm_and_clips_jointly():
    """Two groups, one clip over both: the update of each parameter
    equals the JAX optimizer's on the same gradients."""
    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.wavlm = torch.nn.Linear(4, 4, bias=False)
            self.masker = torch.nn.Linear(4, 4, bias=False)

    class Task:
        def loss(self, model, batch):
            return (model.wavlm.weight * batch.X[0]).sum() \
                + (model.masker.weight * batch.X[1]).sum()

    rng = np.random.default_rng(0)
    grads = rng.standard_normal((2, 4, 4)).astype(np.float32) * 3.0
    toy = Toy()
    with torch.no_grad():           # exact float32 moves from zero
        for p in toy.parameters():
            p.zero_()
    start = {n: p.detach().clone() for n, p in toy.named_parameters()}
    trainer = Trainer(device="cpu", optimizer=separation.pixit_optimizer(
        LR, WAVLM_LR, CLIP))
    names, params = zip(*toy.named_parameters())
    optimizer = trainer.make_optimizer(list(params), list(names))
    assert [g["lr"] for g in optimizer.param_groups] == [WAVLM_LR, LR]
    assert optimizer.gradient_clip_val == CLIP
    trainer.train_step(toy, Task(), optimizer, list(params), [False, False],
                       TrainingBatch(X=torch.from_numpy(grads)))
    tx = jax_separation.pixit_optimizer(LR, WAVLM_LR, CLIP)
    tree = {"wavlm": {"w": jnp.asarray(start["wavlm.weight"].numpy())},
            "masker": {"w": jnp.asarray(start["masker.weight"].numpy())}}
    updates, _ = tx.update({"wavlm": {"w": jnp.asarray(grads[0])},
                            "masker": {"w": jnp.asarray(grads[1])}},
                           tx.init(tree), tree)
    for key in ("wavlm", "masker"):
        moved = (getattr(toy, key).weight - start[f"{key}.weight"]).detach()
        np.testing.assert_allclose(moved.numpy(),
                                   np.asarray(updates[key]["w"]),
                                   rtol=1e-5, atol=1e-9)


def test_frozen_mask_prefixes_as_jax():
    assert ToTaToNet(**HPARAMS).frozen_mask_prefixes() == \
        JaxToTaToNet(**HPARAMS).frozen_mask_prefixes() == []
    frozen = dict(HPARAMS, use_wavlm=True, wavlm_config=dict(WAVLM),
                  wavlm_frozen=True)
    assert ToTaToNet(**frozen).frozen_mask_prefixes() == \
        JaxToTaToNet(**frozen).frozen_mask_prefixes() == ["wavlm"]
    tiny = dict(hidden=32, layers=1, heads=4, ffn=64, conv_channels=16,
                rel_pos_bias=True, pre_ln=False, conv_norm="group")
    assert SSeRiouSS(wav2vec=tiny).frozen_mask_prefixes() == []
    assert SSeRiouSS(wav2vec=tiny, freeze_wav2vec=True) \
        .frozen_mask_prefixes() == ["wav2vec"]


def test_validation_matches_jax_trainer(protocols, models):
    jax_task, port_task = _tasks(protocols, models)
    theirs = JaxTrainer().validate(models[0], jax_task, models[0].params)
    ours = Trainer(device="cpu").validate(models[1], port_task)
    for key in ("der/val/optimal", "der/val"):
        assert ours[key] == pytest.approx(theirs[key], abs=1e-6), key
    assert _rel(ours["loss/val"], theirs["loss/val"]) <= PIXIT_LOSS_RTOL
