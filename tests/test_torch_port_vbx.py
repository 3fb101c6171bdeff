"""The port's community-1 clustering stack against the JAX package.

PLDA, the VBx EM (host float64: 1e-10; ``vbx_em_torch`` in float32
against ``vbx_em_jax``: 1e-4), KMeans (the port's own, against
scikit-learn's through the JAX package: the same partition up to
relabelling), agglomerative, VBx and oracle clustering with the
constrained assignment, ``permutate``, ``oracle_segmentation``, the label
mapping and the DER metrics (1e-9), on seeded inputs. Then the slice as a
whole: the port's ``SpeakerDiarization`` loaded by
``Pipeline.from_pretrained`` from a community-1 style snapshot, with VBx
clustering, against the JAX pipeline built from the same weights and PLDA
on the 30 s corpus file: the same hard clusters, Annotations within one
frame, centroids within 2e-3; with ``num_speakers=2`` (the KMeans
fallback) clusters equal up to a permutation; with ``file["annotation"]``
the same mapped labels.
"""

import numpy as np
import pytest
import torch
from scipy.special import softmax

import pyannote_audio_tpu.core.annotation as jax_annotation
import pyannote_audio_tpu.core.segment as jax_segment
from corpus import default_two_speaker_file
from pyannote_audio_tpu.core.plda import PLDA as JaxPLDA
from pyannote_audio_tpu.metrics import der as jax_der
from pyannote_audio_tpu.ops.permutation import permutate as jax_permutate
from pyannote_audio_tpu.pipelines import clustering as jax_clustering
from pyannote_audio_tpu.pipelines.speaker_diarization import \
    SpeakerDiarization as JaxSpeakerDiarization
from pyannote_audio_tpu.pipelines.utils.oracle import \
    oracle_segmentation as jax_oracle_segmentation
from pyannote_audio_tpu.utils import vbx as jax_vbx
from pyannote_audio_tpu_torch import Pipeline
from pyannote_audio_tpu_torch.core.annotation import Annotation, Timeline
from pyannote_audio_tpu_torch.core.plda import PLDA
from pyannote_audio_tpu_torch.core.segment import (Segment, SlidingWindow,
                                                   SlidingWindowFeature)
from pyannote_audio_tpu_torch.metrics import der
from pyannote_audio_tpu_torch.ops.kmeans import kmeans
from pyannote_audio_tpu_torch.ops.permutation import permutate
from pyannote_audio_tpu_torch.pipelines import clustering
from pyannote_audio_tpu_torch.pipelines.utils.oracle import \
    oracle_segmentation
from pyannote_audio_tpu_torch.utils import vbx
from test_torch_port_config import write_snapshot
from test_torch_port_models import jax_pyannet, jax_wespeaker
from test_torch_port_models import one_torch_thread  # noqa: F401

DIM, LDA_DIM = 256, 32


def plda_params(seed=0, dim=DIM, lda_dim=LDA_DIM):
    """Seeded synthetic PLDA files' contents (the JAX package's recipe)."""
    rng = np.random.default_rng(seed)
    return {"mean1": rng.standard_normal(dim) * 0.01,
            "mean2": rng.standard_normal(lda_dim) * 0.01,
            "lda": rng.standard_normal((dim, lda_dim)) * 0.1,
            "plda_mu": rng.standard_normal(lda_dim) * 0.01,
            "plda_tr": np.linalg.qr(rng.standard_normal((lda_dim,
                                                         lda_dim)))[0],
            "plda_psi": np.abs(rng.standard_normal(lda_dim)) + 0.5}


def port_annotation(annotation) -> Annotation:
    out = Annotation(uri=annotation.uri)
    for segment, track, label in annotation.itertracks(yield_label=True):
        out[Segment(segment.start, segment.end), track] = label
    return out


def speakers(seed, num_chunks=40, num_speakers=3, num_frames=50,
             dim=DIM, spread=0.3):
    """Embeddings of 3 separated voices over (chunk, local speaker), one
    NaN row, and a binarized segmentation with silent and overlapping
    local speakers; -> (embeddings, segmentation (C, F, S))."""
    rng = np.random.default_rng(seed)
    voices = rng.standard_normal((3, dim))
    who = rng.integers(0, 3, size=(num_chunks, num_speakers))
    embeddings = voices[who] + spread * rng.standard_normal(
        (num_chunks, num_speakers, dim))
    embeddings[3, 1] = np.nan
    seg = (rng.uniform(size=(num_chunks, num_frames, num_speakers))
           > 0.55).astype(np.float32)
    seg[5, :, 2] = 0.0                     # a silent local speaker
    seg[6, :, :] = 0.0
    seg[6, :30, 0] = 1.0                   # a clean one
    return embeddings, seg


def port_stats(seg):
    """What fused_count_stats gives the port's clustering."""
    alone = seg.sum(axis=2, keepdims=True) == 1
    return (seg * alone).sum(axis=1), seg.sum(axis=1), seg.shape[1]


def jax_swf(seg):
    return jax_segment.SlidingWindowFeature(
        seg, jax_segment.SlidingWindow(start=0.0, duration=10.0, step=1.0))


def same_partition(a, b):
    """Equal up to a relabelling (a bijection between the ids)."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len({x for x, _ in pairs}) == \
        len({y for _, y in pairs})


# -- PLDA and the VBx EM -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_plda_matches_jax(seed):
    params = plda_params(seed)
    ours, theirs = PLDA(**params), JaxPLDA(**params)
    x = np.random.default_rng(seed + 10).standard_normal((30, DIM))
    np.testing.assert_allclose(ours.phi, theirs.phi, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ours.preprocess(x), theirs.preprocess(x),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(ours(x), theirs(x), rtol=0, atol=1e-10)


def test_plda_from_pretrained_and_vbx_setup(tmp_path):
    params = plda_params(3)
    np.savez(tmp_path / "xvec_transform.npz", mean1=params["mean1"],
             mean2=params["mean2"], lda=params["lda"])
    np.savez(tmp_path / "plda.npz", mu=params["plda_mu"],
             tr=params["plda_tr"], psi=params["plda_psi"])
    x = np.random.default_rng(4).standard_normal((12, DIM))
    np.testing.assert_array_equal(PLDA.from_pretrained(tmp_path)(x),
                                  PLDA(**params)(x))
    ours = vbx.vbx_setup(tmp_path / "xvec_transform.npz",
                         tmp_path / "plda.npz")
    theirs = jax_vbx.vbx_setup(tmp_path / "xvec_transform.npz",
                               tmp_path / "plda.npz")
    np.testing.assert_allclose(ours[0](x), theirs[0](x), atol=1e-10)
    np.testing.assert_allclose(ours[1](ours[0](x)), theirs[1](theirs[0](x)),
                               atol=1e-10)
    np.testing.assert_allclose(ours[2], theirs[2], atol=1e-10)
    for y in (x[0], x):
        np.testing.assert_array_equal(vbx.l2_norm(y), jax_vbx.l2_norm(y))
    with pytest.MonkeyPatch.context() as mp:
        # a hub id that resolves nowhere: no snapshot root, a closed
        # local endpoint
        mp.setenv("PYANNOTE_TPU_HUB", "")
        mp.setenv("HF_ENDPOINT", "http://127.0.0.1:9")
        with pytest.raises(ValueError, match="local"):
            PLDA.from_pretrained("pyannote/speaker-diarization-community-1",
                                 cache_dir=tmp_path / "hub_cache")


def _latent(seed, per_speaker=30, dim=LDA_DIM):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, dim)) * 3.0
    x = np.concatenate([c + rng.standard_normal((per_speaker, dim))
                        for c in centers])
    truth = np.repeat(np.arange(3), per_speaker)
    init = truth.copy()
    init[::5] = (init[::5] + 1) % 3
    init[::11] = 3                         # a redundant fourth speaker
    return x, init, np.abs(rng.standard_normal(dim)) * 4 + 0.5


@pytest.mark.parametrize("seed,fa,fb", [(0, 0.07, 0.8), (1, 0.3, 6.0)])
def test_vbx_em_cluster_vbx_and_VBx_match_jax(seed, fa, fb):
    x, init, phi = _latent(seed)
    ours = vbx.cluster_vbx(init, x, phi, fa=fa, fb=fb, max_iters=20)
    theirs = jax_vbx.cluster_vbx(init, x, phi, fa=fa, fb=fb, max_iters=20)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    gamma0 = softmax(np.eye(4)[init] * 7.0, axis=1)
    ours = vbx.vbx_em(x, phi, fa=fa, fb=fb, gamma=gamma0, max_iters=15)
    theirs = jax_vbx.vbx_em(x, phi, fa=fa, fb=fb, gamma=gamma0,
                            max_iters=15)
    np.testing.assert_allclose(ours[0], theirs[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(ours[2], theirs[2], rtol=1e-12)
    # the reference signature, with a prior vector and the model back
    ours = vbx.VBx(x, phi, Fa=fa, Fb=fb, pi=np.full(4, 0.25),
                   gamma=gamma0, maxIters=10, return_model=True)
    theirs = jax_vbx.VBx(x, phi, Fa=fa, Fb=fb, pi=np.full(4, 0.25),
                         gamma=gamma0, maxIters=10, return_model=True)
    assert len(ours) == len(theirs) == 5 and ours[2] == theirs[2]
    for k in (0, 1, 3, 4):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 2])
def test_vbx_em_torch_matches_vbx_em_jax(seed):
    x, init, phi = _latent(seed)
    gamma0 = softmax(np.eye(4)[init] * 7.0, axis=1)
    gamma, pi, elbos = vbx.vbx_em_torch(x, phi, fa=0.07, fb=0.8,
                                        gamma=gamma0, max_iters=20)
    theirs = jax_vbx.vbx_em_jax(x, phi, fa=0.07, fb=0.8, gamma=gamma0,
                                max_iters=20)
    assert gamma.dtype == torch.float32 and elbos.shape == (20,)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(theirs[0]),
                               atol=1e-4)
    np.testing.assert_allclose(pi.numpy(), np.asarray(theirs[1]), atol=1e-4)
    # against the float64 host EM run as long
    host = vbx.vbx_em(x, phi, fa=0.07, fb=0.8, gamma=gamma0, max_iters=20,
                      epsilon=-np.inf)
    np.testing.assert_allclose(gamma.numpy(), host[0], atol=1e-4)


def test_device_vbx_gate(monkeypatch):
    """PYANNOTE_TPU_DEVICE_VBX is off by default; "1" runs the float32
    EM on the given device, within 1e-4 of the host EM and with the same
    hard clusters."""
    x, init, phi = _latent(5)
    monkeypatch.delenv("PYANNOTE_TPU_DEVICE_VBX", raising=False)
    called = []
    original = vbx.vbx_em_torch
    monkeypatch.setattr(vbx, "vbx_em_torch",
                        lambda *a, **k: called.append(1) or original(*a, **k))
    host = vbx.cluster_vbx(init, x, phi, fa=0.07, fb=0.8, device="cpu")
    assert not called
    monkeypatch.setenv("PYANNOTE_TPU_DEVICE_VBX", "1")
    device = vbx.cluster_vbx(init, x, phi, fa=0.07, fb=0.8, device="cpu")
    assert called and device[0].dtype == np.float32
    np.testing.assert_allclose(device[0], host[0], atol=1e-4)
    np.testing.assert_allclose(device[1], host[1], atol=1e-4)
    np.testing.assert_array_equal(device[0].argmax(1), host[0].argmax(1))


# -- KMeans ------------------------------------------------------------------------

@pytest.mark.parametrize("seed,k", [(0, 2), (1, 3), (2, 4)])
def test_kmeans_partition_matches_sklearn(seed, k):
    from sklearn.cluster import KMeans
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, 16)) * 5.0
    x = np.concatenate([c + rng.standard_normal((20 + 5 * i, 16))
                        for i, c in enumerate(centers)])
    ours = kmeans(x, k)
    assert ours.dtype == np.int64 and ours.shape == (len(x),)
    assert same_partition(ours, KMeans(n_clusters=k, n_init=3,
                                       random_state=42).fit_predict(x))
    np.testing.assert_array_equal(kmeans(x, k), ours)   # seeded


def test_kmeans_rejects_nan_and_keeps_empty_centroids():
    x = np.zeros((6, 4))
    x[3:] = 1.0
    with pytest.raises(ValueError, match="NaN"):
        kmeans(np.where(np.eye(6, 4) > 0, np.nan, x), 2)
    # 3 clusters over 2 distinct points: an id keeps no member
    labels = kmeans(x, 3)
    assert same_partition(labels, [0, 0, 0, 1, 1, 1])


def test_kmeans_clustering_matches_jax(monkeypatch):
    embeddings, seg = speakers(7)
    clean, active, num_frames = port_stats(seg)
    train = embeddings[~np.isnan(embeddings).any(-1)]
    for gate in ("0", "1"):                      # host, and the "device"
        monkeypatch.setenv("PYANNOTE_TPU_DEVICE_KMEANS", gate)
        ours = clustering.KMeansClustering().cluster(train, 3, 3, 3)
        theirs = jax_clustering.KMeansClustering().cluster(train, 3, 3, 3)
        assert same_partition(ours, theirs)
    hard, _, _ = clustering.KMeansClustering()(embeddings, clean,
                                               num_frames, num_clusters=3)
    jax_hard, _, _ = jax_clustering.KMeansClustering()(
        embeddings, segmentations=jax_swf(seg), num_clusters=3)
    # a NaN embedding takes the first id of either labelling
    valid = ~np.isnan(embeddings).any(-1)
    assert same_partition(hard[valid], jax_hard[valid])


# -- clustering --------------------------------------------------------------------

@pytest.mark.parametrize("constrained", [False, True])
def test_agglomerative_clustering_matches_jax(constrained):
    embeddings, seg = speakers(8)
    clean, _, num_frames = port_stats(seg)
    params = {"method": "centroid", "threshold": 0.5, "min_cluster_size": 2}
    ours = clustering.AgglomerativeClustering(
        constrained_assignment=constrained)
    theirs = jax_clustering.AgglomerativeClustering(
        constrained_assignment=constrained)
    ours.instantiate(params)
    theirs.instantiate(params)
    a = ours(embeddings, clean, num_frames, max_clusters=4)
    b = theirs(embeddings, segmentations=jax_swf(seg), max_clusters=4)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], atol=1e-12)
    np.testing.assert_allclose(a[2], b[2], atol=1e-12)


def test_constrained_argmax_matches_jax():
    soft = np.random.default_rng(9).uniform(size=(12, 3, 4))
    soft[2, 1] = np.nan
    np.testing.assert_array_equal(
        clustering.BaseClustering().constrained_argmax(soft),
        jax_clustering.BaseClustering().constrained_argmax(soft))


@pytest.fixture(scope="module")
def vbx_pair():
    params = plda_params(11)
    ours = clustering.VBxClustering(PLDA(**params))
    theirs = jax_clustering.VBxClustering(JaxPLDA(**params))
    return ours, theirs


@pytest.mark.parametrize("seed,threshold,fb,constraints,fallback", [
    (12, 0.5, 3.0, {}, False), (13, 0.7, 0.8, {}, False),
    (12, 0.2, 0.8, {}, False),
    (14, 0.7, 0.8, {"max_clusters": 4}, False),
    (15, 0.7, 0.8, {"min_clusters": 3}, True),
    (16, 0.2, 0.8, {"max_clusters": 3}, True),
    (17, 0.2, 0.8, {"num_clusters": 3}, True)])
def test_vbx_clustering_matches_jax(vbx_pair, monkeypatch, seed, threshold,
                                    fb, constraints, fallback):
    """Exact where VBx decides the count (constrained assignment, silent
    speakers floored); where the count misses the constraints, the KMeans
    fallback's partition up to relabelling."""
    ours, theirs = vbx_pair
    for c in (ours, theirs):
        c.instantiate({"threshold": threshold, "Fa": 0.07, "Fb": fb})
    calls = []
    kmeans_of = clustering.VBxClustering._kmeans
    monkeypatch.setattr(clustering.VBxClustering, "_kmeans",
                        lambda self, *a: calls.append(1) or
                        kmeans_of(self, *a))
    embeddings, seg = speakers(seed)
    clean, active, num_frames = port_stats(seg)
    a = ours(embeddings, clean, num_frames, speaker_frames=active,
             **constraints)
    b = theirs(embeddings, segmentations=jax_swf(seg), **constraints)
    assert bool(calls) == fallback
    assert a[2].shape == b[2].shape
    if not fallback:
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], atol=1e-9)
        np.testing.assert_allclose(a[2], b[2], atol=1e-9)
    else:
        valid = ~np.isnan(embeddings).any(-1)
        assert same_partition(a[0][valid], b[0][valid])


def test_oracle_clustering_matches_jax(tmp_path):
    file = default_two_speaker_file(tmp_path / "oracle.wav", duration=30.0)
    frames = jax_pyannet(duration=10.0).receptive_field
    window = dict(duration=10.0, step=1.0, start=0.0)
    num_chunks = 21
    num_frames = 589
    rng = np.random.default_rng(16)
    seg = (rng.uniform(size=(num_chunks, num_frames, 3)) > 0.6).astype(
        np.float32)
    embeddings = rng.standard_normal((num_chunks, 3, 32))
    clean, _, _ = port_stats(seg)
    ours_file = {"audio": file["audio"], "uri": file["uri"],
                 "annotation": port_annotation(file["annotation"])}
    theirs_file = dict(file)
    port_frames = SlidingWindow(duration=frames.duration, step=frames.step,
                                start=frames.start)
    for emb in (None, embeddings):
        a = clustering.OracleClustering()(
            emb, clean, num_frames,
            segmentations=SlidingWindowFeature(seg, SlidingWindow(**window)),
            file=ours_file, frames=port_frames)
        b = jax_clustering.OracleClustering()(
            emb, segmentations=jax_segment.SlidingWindowFeature(
                seg, jax_segment.SlidingWindow(**window)),
            file=theirs_file, frames=frames)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        if emb is None:
            assert a[2] is None and b[2] is None
        else:
            np.testing.assert_allclose(a[2], b[2], atol=1e-12)
    np.testing.assert_array_equal(ours_file["oracle_segmentations"].data,
                                  theirs_file["oracle_segmentations"].data)


def test_oracle_segmentation_matches_jax(tmp_path):
    file = default_two_speaker_file(tmp_path / "seg.wav", duration=30.0)
    file["duration"] = 29.3                # the last window aligned early
    frames = jax_pyannet(duration=5.0).receptive_field
    ours = oracle_segmentation(
        {"audio": file["audio"], "duration": file["duration"],
         "annotation": port_annotation(file["annotation"])},
        SlidingWindow(duration=5.0, step=0.5),
        SlidingWindow(duration=frames.duration, step=frames.step,
                      start=frames.start))
    theirs = jax_oracle_segmentation(
        file, jax_segment.SlidingWindow(duration=5.0, step=0.5), frames)
    assert ours.data.shape == theirs.data.shape
    assert ours.labels == theirs.labels
    np.testing.assert_array_equal(ours.data, theirs.data)


@pytest.mark.parametrize("shapes,cost", [
    ((3, 3), "mse"), ((2, 3), "mse"), ((3, 2), "mae"), ((4, 4), "mae"),
    ((3, 3), "callable")])
def test_permutate_matches_jax(shapes, cost):
    k1, k2 = shapes
    rng = np.random.default_rng(17)
    y1 = (rng.uniform(size=(5, 40, k1)) > 0.5).astype(np.float32)
    y2 = rng.uniform(size=(5, 40, k2)).astype(np.float32)
    func = (lambda Y, y: np.mean(np.abs(Y - y) ** 3, axis=0)) \
        if cost == "callable" else cost
    a = permutate(y1, y2, cost_func=func, return_cost=True)
    b = jax_permutate(y1, y2, cost_func=func, return_cost=True)
    assert a[1] == b[1]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[2], b[2], atol=1e-6)


# -- label mapping and DER ---------------------------------------------------------

def _annotations(seed):
    rng = np.random.default_rng(seed)
    ours = {"reference": Annotation(uri="f"), "hypothesis": Annotation(
        uri="f")}
    theirs = {"reference": jax_annotation.Annotation(uri="f"),
              "hypothesis": jax_annotation.Annotation(uri="f")}
    for name, labels in (("reference", "ABC"), ("hypothesis", [0, 1, 2, 3])):
        t = 0.0
        for _ in range(25):
            start = t + rng.uniform(0, 1.0)
            end = start + rng.uniform(0.2, 3.0)
            label = labels[rng.integers(len(labels))]
            ours[name][Segment(start, end), "_"] = label
            theirs[name][jax_segment.Segment(start, end), "_"] = label
            t = start + rng.uniform(0.1, 2.0)          # overlaps too
    return ours, theirs


@pytest.mark.parametrize("collar,skip_overlap,uem", [
    (0.0, False, False), (0.5, False, False), (0.25, True, True)])
def test_der_and_optimal_mapping_match_jax(collar, skip_overlap, uem):
    ours, theirs = _annotations(18)
    our_uem = Timeline([Segment(2.0, 40.0)]) if uem else None
    their_uem = jax_annotation.Timeline([jax_segment.Segment(2.0, 40.0)]) \
        if uem else None
    mat, ref, hyp = der.cooccurrence_matrix(ours["reference"],
                                            ours["hypothesis"], uem=our_uem)
    jmat, jref, jhyp = jax_der.cooccurrence_matrix(
        theirs["reference"], theirs["hypothesis"], uem=their_uem)
    assert (ref, hyp) == (jref, jhyp)
    np.testing.assert_allclose(mat, jmat, atol=1e-9)
    assert der.optimal_mapping(ours["reference"], ours["hypothesis"],
                               our_uem) == \
        jax_der.optimal_mapping(theirs["reference"], theirs["hypothesis"],
                                their_uem)
    for name in ("DiarizationErrorRate", "GreedyDiarizationErrorRate"):
        metric = getattr(der, name)(collar=collar, skip_overlap=skip_overlap)
        jax_metric = getattr(jax_der, name)(collar=collar,
                                            skip_overlap=skip_overlap)
        a = metric(ours["reference"], ours["hypothesis"], uem=our_uem,
                   detailed=True)
        b = jax_metric(theirs["reference"], theirs["hypothesis"],
                       uem=their_uem, detailed=True)
        assert a.keys() == b.keys()
        for key in a:
            assert abs(a[key] - b[key]) <= 1e-9, (name, key)
        assert abs(abs(metric) - abs(jax_metric)) <= 1e-9


def test_optimal_mapping_of_the_mixin():
    from pyannote_audio_tpu.pipelines.utils.diarization import \
        SpeakerDiarizationMixin as JaxMixin
    from pyannote_audio_tpu_torch.pipelines.utils.diarization import \
        SpeakerDiarizationMixin
    ours, theirs = _annotations(19)
    a, mapping = SpeakerDiarizationMixin.optimal_mapping(
        {"annotation": ours["reference"],
         "annotated": Timeline([Segment(0.0, 30.0)])},
        ours["hypothesis"], return_mapping=True)
    b, jax_mapping = JaxMixin.optimal_mapping(
        {"annotation": theirs["reference"],
         "annotated": jax_annotation.Timeline([jax_segment.Segment(0.0,
                                                                   30.0)])},
        theirs["hypothesis"], return_mapping=True)
    assert mapping == jax_mapping and a.labels() == b.labels()


# -- the slice as a whole ----------------------------------------------------------

def _capture(monkeypatch, klass, store):
    original = klass.__call__

    def wrapped(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        store.append((np.array(out[0]), None if out[2] is None
                      else np.array(out[2])))
        return out
    monkeypatch.setattr(klass, "__call__", wrapped)


@pytest.fixture(scope="module")
def community_runs(tmp_path_factory):
    """The port loaded from a snapshot and the JAX pipeline, both with
    VBx clustering, on the corpus file: a default run, one with
    ``num_speakers=2`` and one with the file's annotation."""
    root = tmp_path_factory.mktemp("community")
    seg, emb = jax_pyannet(duration=10.0, seed=2), jax_wespeaker(seed=22)
    params = plda_params(21)
    write_snapshot(root, seg, emb, params, clustering={
        "threshold": 0.1, "Fa": 0.07, "Fb": 0.8})
    port = Pipeline.from_pretrained(root, device="cpu")
    jax_pipeline = JaxSpeakerDiarization(
        segmentation=seg, embedding=emb, clustering="VBxClustering",
        plda=JaxPLDA(**params), embedding_exclude_overlap=True,
        segmentation_batch_size=16, embedding_batch_size=16)
    jax_pipeline.instantiate({"segmentation": {"min_duration_off": 0.0},
                              "clustering": {"threshold": 0.1, "Fa": 0.07,
                                             "Fb": 0.8}})
    path = tmp_path_factory.mktemp("corpus") / "two_speakers.wav"
    corpus = default_two_speaker_file(path, duration=30.0)
    file = {"audio": corpus["audio"], "uri": "two_speakers"}
    runs = {"jax": {}, "port": {}}
    with pytest.MonkeyPatch.context() as mp:
        for name, klass in (("jax", jax_clustering.VBxClustering),
                            ("port", clustering.VBxClustering)):
            store = []
            _capture(mp, klass, store)
            runs[name]["clusters"] = store
        for name, pipeline, annotation in (
                ("jax", jax_pipeline, corpus["annotation"]),
                ("port", port, port_annotation(corpus["annotation"]))):
            runs[name]["default"] = pipeline(dict(file))
            runs[name]["two"] = pipeline(dict(file), num_speakers=2)
            runs[name]["mapped"] = pipeline(dict(file, annotation=annotation))
    frame = seg.receptive_field.step
    return port, runs, frame


def _assert_same_annotation(ours, expected, frame):
    a = list(ours.itertracks(yield_label=True))
    b = list(expected.itertracks(yield_label=True))
    assert len(a) == len(b) > 0
    for (seg_a, _, label_a), (seg_b, _, label_b) in zip(a, b):
        assert label_a == label_b
        assert abs(seg_a.start - seg_b.start) <= frame
        assert abs(seg_a.end - seg_b.end) <= frame


def test_community_pipeline_loads_vbx(community_runs):
    port, _, _ = community_runs
    assert type(port).__name__ == "SpeakerDiarization"
    assert isinstance(port.clustering, clustering.VBxClustering)
    assert port.embedding_exclude_overlap is True
    assert port.device == torch.device("cpu")


def test_community_pipeline_matches_jax(community_runs):
    _, runs, frame = community_runs
    (ours, our_centroids), (theirs, their_centroids) = \
        runs["port"]["clusters"][0], runs["jax"]["clusters"][0]
    np.testing.assert_array_equal(ours, theirs)
    assert len(np.unique(ours[ours >= 0])) >= 2
    expected, out = runs["jax"]["default"], runs["port"]["default"]
    assert out.speaker_diarization.labels() == \
        expected.speaker_diarization.labels()
    _assert_same_annotation(out.speaker_diarization,
                            expected.speaker_diarization, frame)
    _assert_same_annotation(out.exclusive_speaker_diarization,
                            expected.exclusive_speaker_diarization, frame)
    np.testing.assert_allclose(out.speaker_embeddings,
                               np.asarray(expected.speaker_embeddings),
                               atol=2e-3)


def test_community_pipeline_kmeans_fallback(community_runs):
    _, runs, _ = community_runs
    ours, theirs = runs["port"]["clusters"][1][0], \
        runs["jax"]["clusters"][1][0]
    assert len(np.unique(theirs[theirs >= 0])) == 2
    assert same_partition(ours, theirs)


def test_community_pipeline_maps_labels(community_runs):
    _, runs, frame = community_runs
    expected, out = runs["jax"]["mapped"], runs["port"]["mapped"]
    np.testing.assert_array_equal(runs["port"]["clusters"][2][0],
                                  runs["jax"]["clusters"][2][0])
    assert set(out.speaker_diarization.labels()) & {"alice", "bob"}
    assert out.speaker_diarization.labels() == \
        expected.speaker_diarization.labels()
    _assert_same_annotation(out.speaker_diarization,
                            expected.speaker_diarization, frame)
    np.testing.assert_allclose(out.speaker_embeddings,
                               np.asarray(expected.speaker_embeddings),
                               atol=2e-3)
