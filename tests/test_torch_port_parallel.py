"""Data parallelism on the port, on the CPU, against the JAX package's.

The JAX package shards over the 8 virtual CPU devices of conftest.py;
the port runs inference on a ``["cpu", "cpu"]`` mesh in one process and
trains with DistributedDataParallel over two gloo ranks, each a process
of ``torch.multiprocessing.spawn`` that joins within its own timeout
(``SPAWN_TIMEOUT``) and whose process group times out before that, so a
collective that one rank never reaches fails the test instead of hanging
the suite. The spawned ranks import only torch and the port: this module
imports the JAX package inside its tests.

Tolerances: the port's mesh run against its own unsharded run within
1e-5 (the same batches in shards of half the size), and against the JAX
package's sharded run within the existing port-vs-JAX bounds (2e-4 for
``Inference``; equal hard clusters, turns within one frame and centroids
within 2e-3 for the pipeline). A two-rank DDP fit against the
single-process fit and the JAX ``Trainer(mesh=)`` fit: rel 1e-4 (abs
1e-5, as tests/test_train.py holds the JAX mesh fit) for every step's
loss, the epoch loss and the validation record, with frame weights that
differ from item to item too; each parameter's change over 3 Adam steps
within 5e-4 per component and 2e-3 relative over all of them (4-5x what
the CPU gives). Each rank's eval-step DER components summed by the
metrics' ``sync``, and the metrics after ``sync``, equal the
single-device values exactly (they are sums of whole frame counts).
"""

import copy
import datetime
import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pyannote_audio_tpu_torch.parallel import (broadcast_from_host0,
                                               make_mesh, pad_to_devices,
                                               shard_batch)

SR = 16000
SPAWN_TIMEOUT = 240.0
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
MESH_ATOL = 1e-5
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
# each parameter's change over 3 Adam steps (lr 1e-3, about 2.5e-3 a
# component), DDP against one process: 4x the largest component gap
# measured on the CPU (1.2e-4, a conv bias whose gradient is rounding
# noise) and 5x the gap of the whole vector relative to its change
# (3.9e-4)
STEP_ATOL, STEP_RTOL = 5e-4, 2e-3
TASK = dict(duration=2.0, batch_size=4, seed=11, max_speakers_per_chunk=3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, args, world=2, timeout=SPAWN_TIMEOUT):
    """``fn(rank, world, port, *args)`` in ``world`` spawned processes;
    each is killed, and the test fails, past ``timeout`` seconds."""
    context = torch.multiprocessing.spawn(
        fn, args=(world, _free_port()) + tuple(args), nprocs=world,
        join=False)
    deadline = time.monotonic() + timeout
    while not context.join(timeout=1.0):
        if time.monotonic() > deadline:
            for process in context.processes:
                process.kill()
            pytest.fail(f"{fn.__name__} did not finish in {timeout} s")


def _init(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)


# -- the mesh ------------------------------------------------------------------

def test_make_mesh_and_helpers_match_jax(monkeypatch):
    from pyannote_audio_tpu.parallel import mesh as jax_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
    mesh = make_mesh(devices=["cpu"] * 3, num_devices=2)
    assert mesh.devices.size == mesh.size == 2 and not mesh.distributed
    assert mesh.axis_names == ("data",)
    assert mesh.devices.shape == jax_mesh.make_mesh(2).devices.shape
    for n, d in ((7, 2), (8, 8), (1, 3), (256, 3)):
        assert pad_to_devices(n, d) == jax_mesh.pad_to_devices(n, d)
    assert broadcast_from_host0("x") == jax_mesh.broadcast_from_host0("x")
    shards = shard_batch({"a": torch.arange(5), "b": (torch.ones(5, 2),)},
                         mesh)
    assert [s["a"].tolist() for s in shards] == [[0, 1, 2], [3, 4]]
    assert [s["b"][0].shape[0] for s in shards] == [3, 2]


def test_trainer_mesh_of_one_process_raises():
    from pyannote_audio_tpu_torch.train import Trainer
    with pytest.raises(ValueError, match="torchrun"):
        Trainer(mesh=make_mesh(devices=["cpu", "cpu"]))
    # a one-device mesh is the plain loop on that device
    trainer = Trainer(mesh=make_mesh(devices=["cpu"]))
    assert trainer.mesh is None and trainer.device == torch.device("cpu")


# -- Inference and SpeakerDiarization over a mesh ---------------------------------

@pytest.mark.parametrize("shared_sinc", ["0", "1"])
def test_inference_mesh_matches_unsharded_and_jax(monkeypatch, shared_sinc):
    from pyannote_audio_tpu.core.inference import Inference as JaxInference
    from pyannote_audio_tpu.parallel import make_mesh as jax_make_mesh
    from pyannote_audio_tpu_torch.core.inference import Inference
    from test_torch_port_inference import (MODEL_TOL, jax_segmenter,
                                           torch_segmenter_from, wave)
    monkeypatch.setenv("PYANNOTE_TPU_SHARED_SINC", shared_sinc)
    jax_model = jax_segmenter(powerset=True, seed=4,
                              permutation_invariant=True)
    port = torch_segmenter_from(jax_model)
    wav = wave(7.3, seed=1)
    plain = Inference(port, step=0.5, batch_size=3, device="cpu")
    sharded = Inference(port, step=0.5, batch_size=3, device="cpu",
                        mesh=make_mesh(devices=["cpu", "cpu"]))
    assert sharded.batch_size == 4
    a = plain.slide(wav, SR).data.numpy()
    b = sharded.slide(wav, SR).data.numpy()
    np.testing.assert_allclose(b, a, atol=MESH_ATOL)
    assert sharded.counts["whole_conv"] == plain.counts["whole_conv"] \
        == int(shared_sinc)
    theirs = JaxInference(jax_model, step=0.5, batch_size=3,
                          skip_aggregation=True, mesh=jax_make_mesh())
    np.testing.assert_allclose(
        b, np.asarray(theirs.slide(wav, SR).data), atol=MODEL_TOL)
    with pytest.raises(ValueError, match="first device"):
        sharded.to("cuda:1")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from corpus import default_two_speaker_file, make_file
    from test_torch_port_models import jax_pyannet, jax_wespeaker
    root = tmp_path_factory.mktemp("parallel_corpus")
    default_two_speaker_file(root / "a.wav", duration=30.0)
    make_file(root / "b.wav", [("carol", 0.5, 6.0), ("dave", 5.0, 12.0),
                               ("carol", 12.5, 16.5)], duration=17.0, seed=3)
    default_two_speaker_file(root / "c.wav", duration=31.3)
    files = [{"audio": str(root / f"{n}.wav"), "uri": n} for n in "abc"]
    return files, jax_pyannet(duration=10.0, seed=2), \
        jax_wespeaker(seed=22)


PANELS = {"TRUNK_PANEL_CORE": 16, "TRUNK_PANEL_HALO": 16,
          "TRUNK_PANEL_BATCH": 8}
PARAMS = {"segmentation": {"min_duration_off": 0.0},
          "clustering": {"method": "centroid", "threshold": 0.05,
                         "min_cluster_size": 1}}


def _diarize(pipeline, files, clustering_module, store):
    """The first file alone, then every file through ``apply_batch``,
    each clustering's hard clusters appended to ``store``."""
    from test_torch_port_pipeline import _capture_clusters
    with pytest.MonkeyPatch.context() as mp:
        _capture_clusters(mp, clustering_module.AgglomerativeClustering,
                          store)
        pipeline.instantiate(PARAMS)
        for name, value in PANELS.items():
            setattr(pipeline, name, value)
        return [pipeline(dict(files[0]), max_speakers=4)] + \
            pipeline.apply_batch([dict(f) for f in files], max_speakers=4)


def _jax_diarization(seg, emb, files, shared="0"):
    from pyannote_audio_tpu.parallel import make_mesh as jax_make_mesh
    from pyannote_audio_tpu.pipelines import clustering as jax_clustering
    from pyannote_audio_tpu.pipelines.speaker_diarization import \
        SpeakerDiarization as JaxSpeakerDiarization
    clusters = []
    with pytest.MonkeyPatch.context() as mp:
        for gate in ("PYANNOTE_TPU_SHARED_SINC", "PYANNOTE_TPU_SHARED_TRUNK"):
            mp.setenv(gate, shared)
        pipeline = JaxSpeakerDiarization(
            segmentation=seg, embedding=emb,
            clustering="AgglomerativeClustering", segmentation_batch_size=8,
            embedding_batch_size=8, mesh=jax_make_mesh())
        outs = _diarize(pipeline, files, jax_clustering, clusters)
    return outs, clusters


def _port_diarization(seg, emb, files, mesh, shared="0"):
    from pyannote_audio_tpu_torch.pipelines import clustering
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    clusters = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYANNOTE_TPU_CONV_FBANK", "0")
        mp.setenv("PYANNOTE_TPU_SEG_BF16", "0")
        for gate in ("PYANNOTE_TPU_SHARED_SINC", "PYANNOTE_TPU_SHARED_TRUNK"):
            mp.setenv(gate, shared)
        pipeline = SpeakerDiarization(
            copy.deepcopy(seg), copy.deepcopy(emb),
            segmentation_batch_size=16, embedding_batch_size=15,
            device="cpu", mesh=mesh)
        outs = _diarize(pipeline, files, clustering, clusters)
    return outs, dict(pipeline.counts), clusters


def _assert_same_outputs(ours, theirs, frame, atol):
    from test_torch_port_pipeline import _assert_same_annotation
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.speaker_diarization.labels() == \
            b.speaker_diarization.labels()
        _assert_same_annotation(a.speaker_diarization,
                                b.speaker_diarization, frame)
        _assert_same_annotation(a.exclusive_speaker_diarization,
                                b.exclusive_speaker_diarization, frame)
        np.testing.assert_allclose(a.speaker_embeddings,
                                   np.asarray(b.speaker_embeddings),
                                   atol=atol)


@pytest.mark.parametrize("shared", ["0", "1"], ids=["exact", "shared_trunk"])
def test_speaker_diarization_mesh_matches_unsharded(corpus, shared):
    """PyanNet + WeSpeaker ResNet34, each batch of segmentation, embedding
    and trunk panels split over a ``["cpu", "cpu"]`` mesh, against the
    port without one: the same hard clusters and Annotations, file by
    file and through ``apply_batch``, on and off the chunk grid. (The JAX
    sharded pipeline raises with a WeSpeaker embedding: see
    ``test_jax_sharded_pipeline_with_wespeaker_raises``.)"""
    from test_torch_port_models import (torch_pyannet_from,
                                        torch_wespeaker_from)
    files, seg, emb = corpus
    files = files[1:]
    models = torch_pyannet_from(seg), torch_wespeaker_from(emb)
    mesh = make_mesh(devices=["cpu", "cpu"])
    ours, counts, clusters = _port_diarization(*models, files, mesh, shared)
    plain, plain_counts, plain_clusters = _port_diarization(
        *models, files, None, shared)
    key = "trunk_panel_batches" if shared == "1" else "chunk_trunk_batches"
    # every batch ran as two shards (the pipeline's batch of 15 rounded up
    # to 16 splits into the same 8 + 8 chunks as 16 unsharded batches of
    # 8 would; counts are per shard)
    assert counts[key] > plain_counts[key] > 0
    assert len(clusters) == len(plain_clusters) == 3
    for a, b in zip(clusters, plain_clusters):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours, plain):
        assert a.speaker_diarization == b.speaker_diarization
        assert a.exclusive_speaker_diarization == \
            b.exclusive_speaker_diarization
    _assert_same_outputs(ours, plain, 0.0, MESH_ATOL)


def test_speaker_diarization_mesh_in_slices_with_hooks(corpus, monkeypatch):
    """A file in forced slices (with their own uploads and trunks), a hook
    seeing every step: the same Annotations and artifacts over a mesh as
    without one."""
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    from pyannote_audio_tpu_torch.pipelines.utils.hook import ArtifactHook
    from test_torch_port_models import (torch_pyannet_from,
                                        torch_wespeaker_from)
    files, seg, emb = corpus
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_MINUTES", "0.2")
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_HALO_SECONDS", "4.0")
    runs = []
    for mesh in (None, make_mesh(devices=["cpu", "cpu"])):
        pipeline = SpeakerDiarization(
            torch_pyannet_from(seg), torch_wespeaker_from(emb),
            segmentation_batch_size=8, embedding_batch_size=8,
            device="cpu", mesh=mesh)
        pipeline.instantiate(PARAMS)
        assert pipeline._plan(SR * 30) is not None       # slices ran
        file = dict(files[0])
        with ArtifactHook("segmentation", "embeddings") as hook:
            output = pipeline(file, max_speakers=4, hook=hook)
        runs.append((output, file["artifact"]))
    (plain, plain_art), (ours, our_art) = runs
    assert ours.speaker_diarization == plain.speaker_diarization
    np.testing.assert_allclose(our_art["embeddings"],
                               plain_art["embeddings"], atol=MESH_ATOL)
    np.testing.assert_allclose(np.asarray(our_art["segmentation"].data),
                               np.asarray(plain_art["segmentation"].data),
                               atol=MESH_ATOL)


def test_speaker_diarization_mesh_matches_jax_sharded(corpus):
    """The debug models of tests/test_multichip.py through both packages'
    sharded pipelines: the JAX one over the 8 virtual CPU devices, the
    port's over two, file by file and through ``apply_batch``, on files
    that end on the chunk grid (the JAX pipeline's sharded masks raise
    on a file that does not)."""
    from pyannote_audio_tpu.core.model import (Problem, Resolution,
                                               Specifications)
    from pyannote_audio_tpu.models.embedding.debug import \
        SimpleEmbeddingModel as JaxSimpleEmbedding
    from pyannote_audio_tpu.models.segmentation.debug import \
        SimpleSegmentationModel as JaxSimpleSegmentation
    from pyannote_audio_tpu_torch.core.model import \
        Specifications as TorchSpecifications
    from pyannote_audio_tpu_torch.models.embedding.debug import \
        SimpleEmbeddingModel
    from pyannote_audio_tpu_torch.models.segmentation.debug import \
        SimpleSegmentationModel
    from pyannote_audio_tpu_torch.utils.convert import (
        debug_embedding_state_dict, debug_segmentation_state_dict)
    import jax
    files = corpus[0][:2]
    seg = JaxSimpleSegmentation()
    seg.specifications = Specifications(
        problem=Problem.MONO_LABEL_CLASSIFICATION,
        resolution=Resolution.FRAME, duration=5.0, classes=["a", "b", "c"],
        powerset_max_classes=2)
    seg.build(jax.random.PRNGKey(2))
    emb = JaxSimpleEmbedding()
    emb.build(jax.random.PRNGKey(3))
    port_seg = SimpleSegmentationModel(TorchSpecifications(
        duration=5.0, classes=["a", "b", "c"], powerset_max_classes=2))
    port_seg.load_reference_state_dict(
        debug_segmentation_state_dict(seg.params)).eval()
    port_emb = SimpleEmbeddingModel().load_reference_state_dict(
        debug_embedding_state_dict(emb.params)).eval()
    ours, counts, clusters = _port_diarization(
        port_seg, port_emb, files, make_mesh(devices=["cpu", "cpu"]))
    assert counts["chunk_trunk_batches"] > 0
    theirs, jax_clusters = _jax_diarization(seg, emb, files)
    assert len(clusters) == len(jax_clusters) == 3
    for a, b in zip(clusters, jax_clusters):
        np.testing.assert_array_equal(a, b)
    _assert_same_outputs(ours, theirs, seg.receptive_field.step, 2e-3)


def test_jax_sharded_pipeline_with_wespeaker_raises(corpus):
    """A fault of the JAX package that the port does not share: with a
    WeSpeaker embedding (its shared-fbank path), the JAX sharded pipeline
    hands the embedding step masks laid out over the mesh where the
    step's jit wants them replicated, and raises on this corpus (the
    port's sharded run of the same files is held above)."""
    files, seg, emb = corpus
    with pytest.raises(ValueError, match="[Ss]harding"):
        _jax_diarization(seg, emb, files[:2])


def test_speaker_diarization_mesh_device_rules():
    from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
        WeSpeakerResNet34
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
        SpeakerDiarization
    g = torch.Generator().manual_seed(0)

    def models():
        return (PyanNet(lstm_hidden=8, linear_hidden=8, generator=g),
                WeSpeakerResNet34(num_blocks=(1, 1, 1, 1), m_channels=4,
                                  generator=g))
    mesh = make_mesh(devices=["cpu", "cpu"])
    pipeline = SpeakerDiarization(*models(), embedding_batch_size=5,
                                  device="cpu", mesh=mesh)
    assert pipeline.embedding_batch_size == 6
    assert pipeline._segmentation.mesh is mesh
    assert pipeline._segmentation.batch_size == 32
    # repeated devices share one replica: the module itself
    assert all(r is pipeline._embedding
               for r in pipeline._embedding_replicas)
    assert pipeline.to("cpu") is pipeline
    with pytest.raises(ValueError, match="first device"):
        pipeline.to("cuda")
    # the device must be the mesh's first (the default is the card)
    with pytest.raises(ValueError, match="first device"):
        SpeakerDiarization(*models(), mesh=mesh)


# -- collectives ---------------------------------------------------------------------

COMPONENTS = ("false_alarm", "missed_detection", "speaker_confusion",
              "speech_total")


def _synced_components(packed):
    """A streaming metric updated from one packed component vector, its
    components summed over the ranks by ``sync`` and packed again."""
    from pyannote_audio_tpu_torch.metrics.streaming import (
        DiarizationErrorRate, OptimalDiarizationErrorRate,
        unpack_der_components)
    width = (len(packed) - 1) // 3
    metric = DiarizationErrorRate() if width == 1 \
        else OptimalDiarizationErrorRate()
    metric.update_from_components(*unpack_der_components(packed, width))
    metric.sync()
    return np.concatenate([np.atleast_1d(np.asarray(getattr(metric, name),
                                                    np.float64))
                           for name in COMPONENTS])


def _collectives_worker(rank, world, port, out):
    from pyannote_audio_tpu_torch.metrics.auroc import BinnedAUROC
    from pyannote_audio_tpu_torch.metrics.streaming import (
        DiarizationErrorRate, OptimalDiarizationErrorRate)
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    from pyannote_audio_tpu_torch.ops.powerset import Powerset
    from pyannote_audio_tpu_torch.parallel.mesh import split_leading
    from pyannote_audio_tpu_torch.train.evaluate import (make_eval_step,
                                                         pad_eval_batch)
    _init(rank, world, port)
    result = {"cache": broadcast_from_host0(f"/cache/of/rank{rank}")}
    mesh = make_mesh()
    result["mesh"] = (mesh.size, mesh.rank, str(mesh.local_device),
                      mesh.distributed)
    # the eval step on each rank's slice of a ragged, padded batch
    model = PyanNet(lstm_hidden=8, linear_hidden=8,
                    generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    X = (0.1 * rng.standard_normal((7, 1, 2 * SR))).astype(np.float32)
    frames = model(torch.from_numpy(X[:1])).shape[1]
    y = (rng.uniform(size=(7, frames, 3)) > 0.6).astype(np.float32)
    Xp, yp, valid = pad_eval_batch(X, y, 8)
    step = make_eval_step(model, powerset=Powerset(3, 2))
    hard4, soft, _ = step(*(torch.from_numpy(split_leading(a, world)[rank])
                            for a in (Xp, yp, valid)))
    # as Trainer.validate does: accumulate the rank's components, sync
    result["eval"] = tuple(_synced_components(components)
                           for components in (hard4, soft))
    # streaming metrics: each rank updates with its half, then syncs
    preds = rng.uniform(size=(6, 20, 3)).astype(np.float32)
    target = (rng.uniform(size=(6, 20, 3)) > 0.5).astype(np.float32)
    mine = slice(3 * rank, 3 * rank + 3)
    metrics = [DiarizationErrorRate(), OptimalDiarizationErrorRate(),
               BinnedAUROC()]
    for m in metrics:
        m.update(torch.from_numpy(preds[mine]) if m is not metrics[-1]
                 else preds[mine], target[mine])
        m.sync()
    result["metrics"] = [m.compute() for m in metrics] + \
        [metrics[1].optimal_threshold]
    torch.save(result, f"{out}.{rank}")
    dist.destroy_process_group()


def test_collectives_equal_single_device(tmp_path):
    """``broadcast_from_host0``, ``make_mesh`` inside a group, the DER
    components of each rank's eval step on its slice of a ragged, padded
    batch, summed by the metrics' ``sync``, and the metrics' ``sync``
    after updates on two gloo ranks, against one device."""
    from pyannote_audio_tpu_torch.metrics.auroc import BinnedAUROC
    from pyannote_audio_tpu_torch.metrics.streaming import (
        DiarizationErrorRate, OptimalDiarizationErrorRate)
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    from pyannote_audio_tpu_torch.ops.powerset import Powerset
    from pyannote_audio_tpu_torch.train.evaluate import (make_eval_step,
                                                         pad_eval_batch)
    out = str(tmp_path / "collectives")
    run_ranks(_collectives_worker, (out,))
    model = PyanNet(lstm_hidden=8, linear_hidden=8,
                    generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    X = (0.1 * rng.standard_normal((7, 1, 2 * SR))).astype(np.float32)
    frames = model(torch.from_numpy(X[:1])).shape[1]
    y = (rng.uniform(size=(7, frames, 3)) > 0.6).astype(np.float32)
    hard4, soft, _ = make_eval_step(model, powerset=Powerset(3, 2))(
        *(torch.from_numpy(a) for a in pad_eval_batch(X, y, 8)))
    preds = rng.uniform(size=(6, 20, 3)).astype(np.float32)
    target = (rng.uniform(size=(6, 20, 3)) > 0.5).astype(np.float32)
    metrics = [DiarizationErrorRate(), OptimalDiarizationErrorRate(),
               BinnedAUROC()]
    for m in metrics:
        m.update(torch.from_numpy(preds) if m is not metrics[-1] else preds,
                 target)
    expected = [m.compute() for m in metrics] + \
        [metrics[1].optimal_threshold]
    for rank in range(2):
        result = torch.load(f"{out}.{rank}", weights_only=False)
        assert result["cache"] == "/cache/of/rank0"
        assert result["mesh"] == (2, rank, "cpu", True)
        np.testing.assert_array_equal(result["eval"][0], hard4.numpy())
        np.testing.assert_array_equal(result["eval"][1], soft.numpy())
        assert result["metrics"] == pytest.approx(expected, rel=1e-12)


# -- DDP training ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def protocols(tmp_path_factory):
    """(JAX protocol, port protocol): the training corpus of
    test_torch_port_train, two of its three files with per-frame loss
    weights drawn uniformly in [0.2, 1]."""
    from test_torch_port_train import protocols as build
    return build.__wrapped__(tmp_path_factory)


def _fit(protocol, task_kwargs, state, mesh=None, checkpoint_dir=None,
         log_dir=None, resume=False, epochs=1, nan_step=None):
    """A port fit of the seeded PyanNet (its weights ``state``): 3 steps
    of 4 chunks; then, with ``resume``, a second fit that resumes from the
    first's epoch-0 checkpoint for one more epoch. ``nan_step`` makes the
    loss of that step non-finite on rank 1."""
    from pyannote_audio_tpu_torch.core.model import attach_specifications
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    from pyannote_audio_tpu_torch.tasks import segmentation as tasks
    from pyannote_audio_tpu_torch.train import Trainer

    def build():
        task = tasks.SpeakerDiarization(protocol, **TASK, **task_kwargs)
        model = PyanNet(lstm_hidden=16, linear_hidden=16)
        task.setup(model)
        attach_specifications(model, task.specifications)
        model.load_state_dict(state)
        if nan_step is not None and mesh is not None and mesh.rank == 1:
            original, calls = task.loss_from_output, [0]

            def loss_from_output(output, batch):
                calls[0] += 1
                loss = original(output, batch)
                return loss * float("nan") if calls[0] == nan_step + 1 \
                    else loss
            task.loss_from_output = loss_from_output
        return task, model

    device = None if mesh is not None else "cpu"
    task, model = build()
    trainer = Trainer(max_epochs=epochs, limit_train_batches=3, mesh=mesh,
                      device=device, checkpoint_dir=checkpoint_dir,
                      log_dir=log_dir)
    trainer.fit(model, task)
    result = {"history": trainer.history, "losses": trainer.step_losses,
              "params": {n: p.detach().clone()
                         for n, p in model.named_parameters()}}
    if resume:
        task, model = build()
        resumed = Trainer(max_epochs=2, limit_train_batches=3, mesh=mesh,
                          device=device)
        resumed.fit(model, task, resume_from=Path(checkpoint_dir) / "epoch_0")
        result["resumed"] = {"history": resumed.history,
                             "losses": resumed.step_losses}
    return result


def _fit_worker(rank, world, port, protocol, task_kwargs, state, out,
                options):
    _init(rank, world, port)
    result = _fit(protocol, task_kwargs, state, mesh=make_mesh(), **options)
    torch.save(result, f"{out}.{rank}")
    dist.destroy_process_group()


def _assert_records_close(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for key in ("loss", "der/val", "der/val/optimal", "loss/val",
                    "der/val/false_alarm", "der/val/confusion"):
            if key in b:
                assert a[key] == pytest.approx(b[key], rel=FIT_RTOL,
                                               abs=FIT_ATOL), key


@pytest.mark.parametrize("task_kwargs", [{}, {"weight": "loss_w"}],
                         ids=["uniform", "frame_weights"])
def test_ddp_fit_matches_single_process_and_jax_mesh(protocols, tmp_path,
                                                     task_kwargs):
    """Two gloo ranks against the single-process fit (steps, records,
    weights, a resumed epoch) and the JAX ``Trainer(mesh=)`` over two of
    the virtual CPU devices (records)."""
    import jax
    from jax.sharding import Mesh as JaxMesh
    from pyannote_audio_tpu.tasks import segmentation as jax_tasks
    from pyannote_audio_tpu.train.trainer import Trainer as JaxTrainer
    from pyannote_audio_tpu_torch.core.model import Model
    from pyannote_audio_tpu_torch.tasks import segmentation as tasks
    from test_torch_port_train import _jax_model, _port_model_from

    jax_task = jax_tasks.SpeakerDiarization(protocols[0], **TASK,
                                            **task_kwargs)
    jax_model = _jax_model(jax_task)
    state = _port_model_from(jax_model, tasks.SpeakerDiarization(
        protocols[1], **TASK, **task_kwargs)).state_dict()
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    out = str(tmp_path / "fit")
    run_ranks(_fit_worker, (protocols[1], task_kwargs, state, out,
                            {"checkpoint_dir": str(ckpt),
                             "log_dir": str(logs), "resume": True}))
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in (0, 1)]
    single = _fit(protocols[1], task_kwargs, state,
                  checkpoint_dir=str(tmp_path / "single"), resume=True)
    jax_trainer = JaxTrainer(
        max_epochs=1, limit_train_batches=3,
        mesh=JaxMesh(np.array(jax.devices()[:2]), ("data",)))
    jax_trainer.fit(jax_model, jax_task)
    # every rank holds the same record and the same weights
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["history"] == ranks[1]["history"]
    for name, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][name]), name
    assert len(ranks[0]["losses"]) == 3
    np.testing.assert_allclose(ranks[0]["losses"], single["losses"],
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    _assert_records_close(ranks[0]["history"], single["history"])
    # each parameter's change from the shared start, DDP against one
    # process: every component and the whole vector (a step that were not
    # applied would leave a gap of about lr per component)
    ours = {n: (p - state[n]).double() for n, p in ranks[0]["params"].items()}
    theirs = {n: (single["params"][n] - state[n]).double() for n in ours}
    for name in ours:
        np.testing.assert_allclose(ours[name].numpy(), theirs[name].numpy(),
                                   rtol=0, atol=STEP_ATOL, err_msg=name)
    gap = torch.cat([(ours[n] - theirs[n]).flatten() for n in ours])
    moved = torch.cat([t.flatten() for t in theirs.values()])
    assert float(moved.abs().median()) > 4 * STEP_ATOL
    assert float(gap.norm()) <= STEP_RTOL * float(moved.norm())
    # resume_from under DDP continues as the single-process resume does
    np.testing.assert_allclose(ranks[0]["resumed"]["losses"],
                               single["resumed"]["losses"],
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    _assert_records_close(ranks[0]["resumed"]["history"],
                          single["resumed"]["history"])
    _assert_records_close(ranks[0]["history"], jax_trainer.history)
    # rank 0 alone wrote: one metrics line, a checkpoint that reloads
    assert len((logs / "metrics.jsonl").read_text().splitlines()) == 1
    reloaded = Model.from_pretrained(ckpt / "epoch_0")
    for name, p in reloaded.named_parameters():
        assert torch.equal(p.detach(), ranks[0]["params"][name]), name


def test_frame_weights_make_the_rank_mean_wrong(protocols):
    """The normalisation the DDP loss needs: with frame weights, the mean
    of the two half-batch losses is not the batch's loss; weighed by
    ``loss_normalizer`` it is."""
    from pyannote_audio_tpu_torch.core.task import TrainingBatch
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    from pyannote_audio_tpu_torch.core.model import attach_specifications
    from pyannote_audio_tpu_torch.tasks import segmentation as tasks
    from pyannote_audio_tpu_torch.train import Trainer
    task = tasks.SpeakerDiarization(protocols[1], weight="loss_w", **TASK)
    model = PyanNet(lstm_hidden=16, linear_hidden=16,
                    generator=torch.Generator().manual_seed(0))
    task.setup(model)
    attach_specifications(model, task.specifications)
    trainer = Trainer(device="cpu")
    # the fits' second and third steps are such batches (the first has a
    # chunk of the file without weights, and none)
    batch = trainer.to_device(next(b for b in task.train_batches(epoch=0)
                                   if b.weight is not None))
    halves = [TrainingBatch(X=batch.X[s], y=batch.y[s],
                            weight=batch.weight[s])
              for s in (slice(0, 2), slice(2, 4))]
    with torch.no_grad():
        whole = float(task.loss(model, batch))
        losses = [float(task.loss(model, h)) for h in halves]
        d = [float(task.loss_normalizer(h)) for h in halves]
    assert abs(np.mean(losses) - whole) > 1e-3 * abs(whole)
    assert np.dot(losses, d) / sum(d) == pytest.approx(whole, rel=1e-6)


def _vad_validation(protocol, mesh=None):
    """``Trainer.validate`` of a seeded PyanNet under VAD (an AUROC task)
    on 5 chunks in batches of 4: a full batch and a tail of one chunk,
    which a two-rank mesh pads so that no rank forwards nothing."""
    from pyannote_audio_tpu_torch.core.model import attach_specifications
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    from pyannote_audio_tpu_torch.tasks import segmentation as tasks
    from pyannote_audio_tpu_torch.train import Trainer
    task = tasks.VoiceActivityDetection(protocol, duration=2.0, batch_size=4)
    model = PyanNet(lstm_hidden=8, linear_hidden=8,
                    generator=torch.Generator().manual_seed(5))
    task.setup(model)
    attach_specifications(model, task.specifications,
                          torch.Generator().manual_seed(6))
    trainer = Trainer(mesh=mesh, device=None if mesh is not None else "cpu")
    return trainer.validate(model, task, max_chunks=5, eval_batch_size=4)


def _vad_worker(rank, world, port, protocol, out):
    _init(rank, world, port)
    torch.save(_vad_validation(protocol, make_mesh()), f"{out}.{rank}")
    dist.destroy_process_group()


def test_ddp_validation_of_an_auroc_task(protocols, tmp_path):
    """Two gloo ranks validate a VAD task (AUROC, a ragged tail of one
    chunk) as one process does."""
    out = str(tmp_path / "vad")
    run_ranks(_vad_worker, (protocols[1], out))
    expected = _vad_validation(protocols[1])
    assert set(expected) == {"auroc/val", "loss/val"}
    for rank in range(2):
        record = torch.load(f"{out}.{rank}", weights_only=False)
        assert record["auroc/val"] == expected["auroc/val"]
        assert record["loss/val"] == pytest.approx(expected["loss/val"],
                                                   rel=1e-5)


def _nan_worker(rank, world, port, protocol, state, out):
    _init(rank, world, port)
    result = _fit(protocol, {}, state, mesh=make_mesh(), nan_step=1)
    torch.save(result, f"{out}.{rank}")
    dist.destroy_process_group()


def test_nan_on_one_rank_is_skipped_by_both(protocols, tmp_path):
    from pyannote_audio_tpu_torch.core.model import attach_specifications
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    from pyannote_audio_tpu_torch.tasks import segmentation as tasks
    model = PyanNet(lstm_hidden=16, linear_hidden=16,
                    generator=torch.Generator().manual_seed(3))
    task = tasks.SpeakerDiarization(protocols[1], **TASK)
    task.setup(model)
    attach_specifications(model, task.specifications)
    out = str(tmp_path / "nan")
    run_ranks(_nan_worker, (protocols[1], model.state_dict(), out))
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in (0, 1)]
    for result in ranks:
        finite = np.isfinite(result["losses"])
        assert finite.tolist() == [True, False, True]
    for name, p in ranks[0]["params"].items():
        assert torch.isfinite(p).all() and \
            torch.equal(p, ranks[1]["params"][name]), name
