"""Speaker embedding and verification.

Counterpart of pyannote_audio_tpu/pipelines/speaker_verification.py: a
uniform ``wrapper(waveforms, masks=None) -> (batch, dimension)`` numpy
embedding over four routes, the ``PretrainedSpeakerEmbedding`` dispatch
that picks one by the JAX package's name and directory rules, the
whole-file ``SpeakerEmbedding`` pipeline with VAD-weighted pooling, and
``verification_trials_eer``. Each route runs the port's own network:

- a reference ``pytorch_model.bin`` (x-vectors, any WeSpeaker depth)
  through ``Model.from_pretrained``; masks weight the statistics pooling,
  and a row whose mask covers less than ``min_num_samples`` is NaN;
- a WeSpeaker ``.onnx`` file, its initializers read by utils/onnx.py
  onto the ResNet of the depth its weight names show;
- a SpeechBrain snapshot directory onto models/embedding/ecapa.py;
- a NeMo ``.nemo`` archive or directory onto models/embedding/titanet.py.

The last two take masks as the reference's wrappers do: nearest-upsampled
to samples, binarized at 0.5, the speech samples compacted to the front
on the host (one loop over rows in numpy, one upload and one fetch per
batch), and a frame mask from the compacted lengths (relative lengths for
SpeechBrain, the ``1 + samples // hop`` prefix for NeMo); rows shorter
than ``min_num_samples`` are NaN. Every wrapper and ``SpeakerEmbedding``
runs on ``device``: the CUDA card when it is None (raising without
one), ``device="cpu"`` on the CPU. Hub ids raise: there is no hub
access.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Mapping, Optional, Union

import numpy as np
import torch

from ..core.inference import Inference
from ..core.io import Audio, AudioFile
from ..core.pipeline import Pipeline
from ..metrics.streaming import EqualErrorRate
from ..utils.runtime import check_device
from ..utils.signal import nearest_binary_mask
from .utils.getter import PipelineModel, get_model
from .voice_activity_detection import max_over_classes


def analytic_min_num_samples(model) -> int:
    """Smallest input that still gives one pooled frame: the model's own
    ``min_num_samples`` (ECAPA, TitaNet), else one fbank window widened by
    the ResNet trunk's 8x time reduction, else 640 samples (SincNet's
    receptive minimum)."""
    own = getattr(model, "min_num_samples", None)
    if isinstance(own, (int, np.integer)):
        return int(own)
    if hasattr(model, "frame_length"):
        window = int(model.sample_rate * model.frame_length * 0.001)
        shift = int(model.sample_rate * model.frame_shift * 0.001)
        return window + 7 * shift
    return 640


def _host(array) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.detach().float().cpu().numpy()
    return np.asarray(array, dtype=np.float32)


class _PretrainedEmbedding:
    """An embedding model on ``device``, in eval mode."""

    def __init__(self, model: torch.nn.Module,
                 device: Union[str, torch.device, None]):
        self.device = check_device(device)
        self.model = model.to(self.device).eval()

    def to(self, device: Union[str, torch.device]) -> "_PretrainedEmbedding":
        self.device = check_device(device)
        self.model.to(self.device)
        return self

    @property
    def sample_rate(self) -> int:
        return self.model.sample_rate

    @property
    def dimension(self) -> int:
        return self.model.dimension

    @property
    def metric(self) -> str:
        return "cosine"

    @property
    def min_num_samples(self) -> int:
        return analytic_min_num_samples(self.model)


class PyannoteAudioPretrainedSpeakerEmbedding(_PretrainedEmbedding):
    """A model instance or a reference checkpoint (path or
    ``{checkpoint, subfolder}`` dict); masks weight its pooling."""

    def __init__(self, embedding: PipelineModel,
                 device: Union[str, torch.device, None] = None,
                 token=None, cache_dir=None):
        self.embedding = embedding
        super().__init__(get_model(embedding), device)

    @torch.inference_mode()
    def __call__(self, waveforms, masks=None) -> np.ndarray:
        """waveforms (batch, 1, samples); masks (batch, frames) or None."""
        x = torch.as_tensor(_host(waveforms)).to(self.device)
        weights = None if masks is None else \
            torch.as_tensor(_host(masks)).to(self.device)
        emb = self.model(x, weights=weights).float().cpu().numpy()
        if masks is not None:
            # too little speech: the reference's NaN sentinel
            masks = _host(masks)
            active = masks.sum(axis=-1) * x.shape[-1] / masks.shape[-1]
            emb[active < self.min_num_samples] = np.nan
        return emb


# (layer3 blocks, bottleneck) of WeSpeaker's published .onnx depths
_ONNX_DEPTHS = {(6, False): "WeSpeakerResNet34",
                (36, True): "WeSpeakerResNet152",
                (48, True): "WeSpeakerResNet221",
                (64, True): "WeSpeakerResNet293"}


class ONNXWeSpeakerPretrainedSpeakerEmbedding(
        PyannoteAudioPretrainedSpeakerEmbedding):
    """A WeSpeaker ``.onnx`` file's weights on the port's ResNet.

    The initializers keep the exported module's parameter names
    ("layer1.0.conv1.weight", ...), which become the reference
    ``resnet.*`` state dict; the depth comes from the number of layer3
    blocks and the presence of ``conv3``, the width and the embedding
    size from the weights' shapes. The trunk runs in bf16, as the JAX
    package's ONNX route does.
    """

    def __init__(self, embedding: Union[str, Path],
                 device: Union[str, torch.device, None] = None):
        from ..models.embedding import wespeaker
        from ..utils.onnx import read_onnx_initializers

        path = Path(embedding)
        if not path.is_file():
            raise ValueError(
                f"wespeaker embedding {embedding!r} is not a local .onnx "
                f"file: this package loads local files only (it has no hub "
                f"access)")
        state = {k if k.startswith("resnet.") else f"resnet.{k}": v
                 for k, v in read_onnx_initializers(path).items()}
        n3 = len({k.split(".")[2] for k in state
                  if k.startswith("resnet.layer3.")})
        bottleneck = any(".conv3." in k for k in state
                         if k.startswith("resnet.layer1."))
        arch = _ONNX_DEPTHS.get((n3, bottleneck))
        if arch is None:
            raise ValueError(
                f"could not infer WeSpeaker architecture from {path} "
                f"(layer3 has {n3} blocks, bottleneck={bottleneck})")
        model = getattr(wespeaker, arch)(
            m_channels=int(state["resnet.conv1.weight"].shape[0]),
            embed_dim=int(state["resnet.seg_1.weight"].shape[0]))
        for key in model.state_dict():
            if key.endswith("num_batches_tracked"):
                state.setdefault(key, np.asarray(0, dtype=np.int64))
        super().__init__(model.load_reference_state_dict(state), device)
        self.embedding = embedding


def _compacted_masked_embed(model, waveforms, masks, frame_mask_fn,
                            device: torch.device) -> np.ndarray:
    """The SpeechBrain and NeMo wrappers' masked batch: speech samples
    compacted to the front on the host, trimmed to the longest row,
    ``frame_mask_fn(wav_lens, max_len, num_frames)`` as the model's
    frame mask; rows shorter than ``model.min_num_samples`` are NaN."""
    waveforms = _host(waveforms)
    batch_size, num_channels, num_samples = waveforms.shape
    if num_channels != 1:
        raise ValueError(f"expected mono waveforms, got {num_channels} "
                         f"channels")
    signals = waveforms[:, 0, :]
    if masks is None:
        wav_lens = np.full(batch_size, num_samples, dtype=np.int64)
    else:
        imasks = nearest_binary_mask(_host(masks), num_samples)
        wav_lens = imasks.sum(axis=1)
        compacted = np.zeros_like(signals)
        for i in range(batch_size):
            keep = signals[i, imasks[i]]
            compacted[i, :keep.shape[0]] = keep
        signals = compacted
    max_len = int(wav_lens.max())
    if max_len < model.min_num_samples:
        return np.full((batch_size, model.dimension), np.nan,
                       dtype=np.float32)
    too_short = wav_lens < model.min_num_samples
    wav_lens = wav_lens.astype(np.float64)
    wav_lens[too_short] = max_len
    frame_mask = frame_mask_fn(wav_lens, max_len, model.num_frames(max_len))
    with torch.inference_mode():
        emb = model.forward_with_frame_mask(
            torch.from_numpy(np.ascontiguousarray(signals[:, :max_len]))
            .to(device), torch.from_numpy(frame_mask).to(device))
        emb = emb.float().cpu().numpy()
    emb[too_short] = np.nan
    return emb


class SpeechBrainPretrainedSpeakerEmbedding(_PretrainedEmbedding):
    """A local SpeechBrain snapshot (``embedding_model.ckpt`` +
    ``hyperparams.yaml``) on the port's ECAPA-TDNN, or an ``ECAPA_TDNN``
    instance."""

    def __init__(self, embedding: Union[str, Path, torch.nn.Module] =
                 "speechbrain/spkrec-ecapa-voxceleb",
                 device: Union[str, torch.device, None] = None,
                 token=None, cache_dir=None):
        from ..models.embedding.ecapa import ECAPA_TDNN
        self.embedding = embedding
        super().__init__(embedding if isinstance(embedding, torch.nn.Module)
                         else ECAPA_TDNN.from_speechbrain(embedding), device)

    def __call__(self, waveforms, masks=None) -> np.ndarray:
        def relative_frame_mask(wav_lens, max_len, num_frames):
            # speechbrain's length_to_mask: arange(T) < relative length * T
            rel = wav_lens / max_len
            return (np.arange(num_frames)[None, :]
                    < rel[:, None] * num_frames).astype(np.float32)
        return _compacted_masked_embed(self.model, waveforms, masks,
                                       relative_frame_mask, self.device)


class NeMoPretrainedSpeakerEmbedding(_PretrainedEmbedding):
    """A local NeMo ``.nemo`` archive or extracted directory on the port's
    TitaNet (PyYAML reads its ``model_config.yaml``), or a ``TitaNet``
    instance. As in the JAX package, the compacted speech is embedded
    (the reference passes the uncompacted waveforms with compacted
    lengths)."""

    def __init__(self, embedding: Union[str, Path, torch.nn.Module] =
                 "nvidia/speakerverification_en_titanet_large",
                 device: Union[str, torch.device, None] = None,
                 token=None, cache_dir=None):
        from ..models.embedding.titanet import TitaNet
        self.embedding = embedding
        super().__init__(embedding if isinstance(embedding, torch.nn.Module)
                         else TitaNet.from_nemo(embedding), device)

    def __call__(self, waveforms, masks=None) -> np.ndarray:
        hop = self.model.hop_length

        def prefix_frame_mask(wav_lens, max_len, num_frames):
            # NeMo's valid lengths: 1 + samples // hop frames
            valid = 1 + (wav_lens // hop).astype(np.int64)
            return (np.arange(num_frames)[None, :]
                    < np.minimum(valid, num_frames)[:, None]
                    ).astype(np.float32)
        return _compacted_masked_embed(self.model, waveforms, masks,
                                       prefix_frame_mask, self.device)


def PretrainedSpeakerEmbedding(embedding: PipelineModel,
                               device: Union[str, torch.device, None] = None,
                               token=None, cache_dir=None):
    """The wrapper for ``embedding``, by the JAX package's rules: a name
    with "speechbrain" or a directory holding ``embedding_model.ckpt``
    (SpeechBrain); a name with "nvidia" or "nemo" or a directory holding
    ``model_weights.ckpt`` (NeMo); a file named "*wespeaker*" or "*.onnx"
    (ONNX); anything else (an instance, a checkpoint path or dict)
    through ``Model.from_pretrained``."""
    if isinstance(embedding, (str, Path)):
        name, path = str(embedding), Path(embedding)
        lowered = name.lower()
        if "speechbrain" in lowered or (
                path.is_dir() and (path / "embedding_model.ckpt").is_file()):
            return SpeechBrainPretrainedSpeakerEmbedding(name, device=device)
        if "nvidia" in lowered or "nemo" in lowered or (
                path.is_dir() and (path / "model_weights.ckpt").is_file()):
            return NeMoPretrainedSpeakerEmbedding(name, device=device)
        # checkpoint directories (even ones named *wespeaker*) load as
        # checkpoints; files and names go to the ONNX route
        if ("wespeaker" in lowered or lowered.endswith(".onnx")) \
                and not path.is_dir():
            return ONNXWeSpeakerPretrainedSpeakerEmbedding(name,
                                                           device=device)
    return PyannoteAudioPretrainedSpeakerEmbedding(embedding, device=device)


class SpeakerEmbedding(Pipeline):
    """Whole-file speaker embedding, weighted by voice activity.

    With a ``segmentation`` model, the weights are the cubed scores of an
    ``Inference`` over it (the maximum over its classes, taken on the
    device before aggregation; NaN edges count as silence), so that
    uncertain frames barely count. ``apply`` returns a (1, dimension)
    array. ``device`` is the CUDA card when None (raising without one);
    ``token``, ``use_auth_token`` and ``cache_dir`` are accepted and
    unused.
    """

    def __init__(self, embedding: PipelineModel = None,
                 segmentation: Optional[PipelineModel] = None,
                 device: Union[str, torch.device, None] = None,
                 use_auth_token=None, token=None, cache_dir=None):
        super().__init__()
        self.embedding = embedding
        self.segmentation = segmentation
        self._embedding = PretrainedSpeakerEmbedding(embedding, device=device)
        self.device = self._embedding.device
        self._voice_activity = None if segmentation is None else Inference(
            get_model(segmentation), pre_aggregation_hook=max_over_classes,
            device=self.device)
        self._audio = Audio(sample_rate=self._embedding.sample_rate,
                            mono="downmix")

    def default_parameters(self):
        return {}

    def to(self, device: Union[str, torch.device]) -> "SpeakerEmbedding":
        super().to(device)
        self._embedding.to(device)
        return self

    def apply(self, file: AudioFile,
              hook: Optional[Callable] = None) -> np.ndarray:
        waveform, _ = self._audio(file)
        if self._voice_activity is None:
            return self._embedding(waveform[None])
        activations = self._voice_activity(file)
        weights = np.nan_to_num(activations.data.reshape(-1), nan=0.0) ** 3
        return self._embedding(waveform[None], masks=weights[None])


def verification_trials_eer(pipeline: SpeakerEmbedding,
                            trials: Iterable[Mapping]) -> float:
    """EER over ``{file1, file2, reference}`` trials, each scored by the
    cosine similarity of the two files' embeddings."""
    from scipy.spatial.distance import cdist
    metric = EqualErrorRate()
    for trial in trials:
        score = 1.0 - cdist(pipeline(trial["file1"]),
                            pipeline(trial["file2"]), metric="cosine")[0, 0]
        metric.update([score], [int(trial["reference"])])
    return metric.compute()


def main(protocol: Union[str, object] = "VoxCeleb.SpeakerVerification.VoxCeleb1",
         subset: str = "test",
         embedding: PipelineModel = "pyannote/embedding",
         segmentation: Optional[PipelineModel] = None,
         device: Union[str, torch.device, None] = None) -> float:
    """Evaluate a speaker-embedding pipeline on a protocol's verification
    trials: ``{subset}_trial()`` yields ``{file1, file2, reference}``;
    each distinct file (by its ``audio``) is embedded once, each trial
    scored by cosine similarity, and the EER printed and returned.
    ``protocol`` is a protocol or a registered name; ``device`` is the
    CUDA card when None (raising without one)."""
    from scipy.spatial.distance import cdist

    from ..utils.database import get_protocol

    proto = get_protocol(protocol) if isinstance(protocol, str) else protocol
    trials = getattr(proto, f"{subset}_trial", None)
    if trials is None:
        raise ValueError(
            f"protocol {protocol!r} has no {subset}_trial iterator: "
            "verification trials need a SpeakerVerification protocol")
    pipeline = SpeakerEmbedding(embedding=embedding,
                                segmentation=segmentation, device=device)
    embeddings = {}

    def embed(file) -> np.ndarray:
        key = file["audio"] if isinstance(file, Mapping) else file
        if key not in embeddings:
            embeddings[key] = pipeline(file)
        return embeddings[key]

    metric = EqualErrorRate()
    for trial in trials():
        score = 1.0 - cdist(embed(trial["file1"]), embed(trial["file2"]),
                            metric="cosine")[0, 0]
        metric.update([score], [int(trial["reference"])])
    eer = float(metric.compute())
    print(f"EER = {eer:.2%}")
    return eer
