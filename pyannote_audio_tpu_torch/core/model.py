"""What a model predicts, its output frames in time, and loading reference
checkpoints.

Counterpart of the Specifications part of pyannote_audio_tpu/core/model.py
and of its ``Model.from_pretrained`` for reference-layout checkpoints
(``pytorch_model.bin``: ``state_dict``, ``hyper_parameters`` and the
``pyannote.audio`` block naming the architecture and its
specifications). The port's models are ``torch.nn.Module``s;
``FrameModel`` adds the frame arithmetic that Inference and the
diarization pipeline read, and ``Model.from_pretrained`` builds one of the
ported architectures (PyanNet, SSeRiouSS, ToTaToNet, XVectorMFCC,
XVectorSincNet, every WeSpeaker ResNet depth and the two debug models)
from such a checkpoint. For training (the JAX ``Model`` wrapper's
training surface): ``Trainable`` freezes modules by name, as optimizer
masks over parameter-name prefixes, and ``attach_specifications`` sets a
task's specifications on a model, rebuilding its head where the output
dimension changed and keeping every other weight.
"""

from __future__ import annotations

import importlib
import pickle
from dataclasses import dataclass
from enum import Enum
from math import comb
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from .segment import SlidingWindow

CHECKPOINT = "pytorch_model.bin"


class Problem(Enum):
    BINARY_CLASSIFICATION = 0
    MONO_LABEL_CLASSIFICATION = 1
    MULTI_LABEL_CLASSIFICATION = 2
    REPRESENTATION = 3
    REGRESSION = 4


class Resolution(Enum):
    FRAME = 1
    CHUNK = 2


@dataclass(frozen=True)
class Specifications:
    """A segmentation model's task: chunk duration and (powerset) classes.

    ``powerset_max_classes`` set means a mono-label powerset output over
    ``classes`` (at most that many active at once). The other fields are
    the ones a reference checkpoint carries; the port reads them and
    writes them back, and its pipelines use none of them.
    """

    duration: float
    classes: List[str]
    powerset_max_classes: Optional[int] = None
    problem: Problem = Problem.MONO_LABEL_CLASSIFICATION
    resolution: Resolution = Resolution.FRAME
    min_duration: Optional[float] = None
    warm_up: Tuple[float, float] = (0.0, 0.0)
    permutation_invariant: bool = False

    @property
    def powerset(self) -> bool:
        return self.powerset_max_classes is not None

    @property
    def num_powerset_classes(self) -> int:
        return sum(comb(len(self.classes), k)
                   for k in range(self.powerset_max_classes + 1))

    @property
    def dimension(self) -> int:
        return self.num_powerset_classes if self.powerset \
            else len(self.classes)

    def to_dict(self) -> Dict[str, Any]:
        """Plain values, in the JAX package's ``Specifications.to_dict``
        layout (which both packages' loaders read)."""
        return {"problem": self.problem.name,
                "resolution": self.resolution.name,
                "duration": self.duration, "min_duration": self.min_duration,
                "warm_up": list(self.warm_up), "classes": list(self.classes),
                "powerset_max_classes": self.powerset_max_classes,
                "permutation_invariant": self.permutation_invariant}

    @classmethod
    def from_checkpoint(cls, specs):
        """From a checkpoint's ``specifications``: a plain dict, or the
        object that unpickling a reference checkpoint gave; a multi-task
        model's list or tuple of them gives a tuple."""
        if isinstance(specs, (list, tuple)):
            return tuple(cls.from_checkpoint(s) for s in specs)
        def get(key, default=None):
            if isinstance(specs, Mapping):
                return specs.get(key, default)
            return getattr(specs, key, default)

        def enum(kind, value):
            return kind[value.name] if hasattr(value, "name") \
                else kind[str(value)]
        return cls(duration=get("duration"),
                   classes=list(get("classes") or []),
                   powerset_max_classes=get("powerset_max_classes"),
                   problem=enum(Problem, get("problem",
                                             "MONO_LABEL_CLASSIFICATION")),
                   resolution=enum(Resolution, get("resolution", "FRAME")),
                   min_duration=get("min_duration"),
                   warm_up=tuple(get("warm_up") or (0.0, 0.0)),
                   permutation_invariant=bool(
                       get("permutation_invariant", False)))


def first_specifications(specs) -> Specifications:
    """A model's specifications, or the first of a multi-task tuple (the
    one that fixes the chunk duration and the output frames)."""
    return specs[0] if isinstance(specs, tuple) else specs


class Trainable:
    """Freezing by top-level module name, for ``nn.Module`` models.

    Frozen names are recorded in ``frozen_modules``, which
    ``Trainer.fit`` reads as prefixes: a frozen parameter stays in the
    optimizer (its moments advance) and only its update is zeroed. A
    prefix matches a whole component of a parameter's dotted name or a
    leading run of components, so "lstm" never freezes "pre_lstm_proj".
    """

    @property
    def frozen_modules(self) -> List[str]:
        return self.__dict__.setdefault("_frozen_modules", [])

    @frozen_modules.setter
    def frozen_modules(self, names: List[str]) -> None:
        self.__dict__["_frozen_modules"] = list(names)

    def _top_level_modules(self) -> List[str]:
        return [name for name, _ in self.named_children()]

    def _checked(self, modules) -> List[str]:
        names = [modules] if isinstance(modules, str) else list(modules)
        missing = [n for n in names if n not in self._top_level_modules()]
        if missing:
            raise ValueError(
                f"Could not find the following modules: {missing}.")
        return names

    def freeze_by_name(self, modules, recurse: bool = True) -> List[str]:
        """Freeze top-level modules (with all their parameters)."""
        names = self._checked(modules)
        self.frozen_modules = self.frozen_modules + [
            n for n in names if n not in self.frozen_modules]
        return names

    def unfreeze_by_name(self, modules, recurse: bool = True) -> List[str]:
        names = self._checked(modules)
        self.frozen_modules = [n for n in self.frozen_modules
                               if n not in names]
        return names

    def freeze_up_to(self, module_name: str) -> List[str]:
        """Freeze every top-level module up to and including
        ``module_name``, in registration order."""
        known = self._top_level_modules()
        return self.freeze_by_name(
            known[:known.index(self._checked(module_name)[0]) + 1])

    def unfreeze_up_to(self, module_name: str) -> List[str]:
        known = self._top_level_modules()
        return self.unfreeze_by_name(
            known[:known.index(self._checked(module_name)[0]) + 1])


def is_frozen(name: str, prefixes) -> bool:
    """Whether the parameter ``name`` (dotted) lies under one of
    ``prefixes``: the name itself, a leading run of its components, or
    any one component."""
    parts = name.split(".")
    return any(name == prefix or name.startswith(prefix + ".")
               or prefix in parts for prefix in prefixes)


def attach_specifications(model: nn.Module, specifications,
                          generator: Optional[torch.Generator] = None
                          ) -> nn.Module:
    """Give ``model`` a task's ``specifications``; where its output
    dimension changes, a new ``classifier`` (torch.nn.Linear's
    U(-1/sqrt(in), 1/sqrt(in)) init from ``generator``, on the old one's
    device) replaces the old one. Every other weight is kept. A
    multi-task model's heads are its own (ToTaToNet's classifier scores
    one source at a time), so a tuple of specifications changes none."""
    model.specifications = specifications
    if isinstance(specifications, tuple):
        return model
    head = getattr(model, "classifier", None)
    dimension = first_specifications(specifications).dimension
    if isinstance(head, nn.Linear) and head.out_features != dimension:
        new = nn.Linear(head.in_features, dimension)
        bound = head.in_features ** -0.5
        with torch.no_grad():
            for p in (new.weight, new.bias):
                p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                        - bound)
        model.classifier = new.to(head.weight.device)
    return model


class FrameModel(Trainable):
    """Mixin for frame-resolution models: subclasses define
    ``receptive_field_size`` and ``receptive_field_center`` (in samples)
    and a ``sample_rate``. A multi-task model's outputs share these
    frames."""

    sample_rate: int

    @property
    def receptive_field(self) -> SlidingWindow:
        """Output frames as a SlidingWindow (as the JAX Model computes it)."""
        size = self.receptive_field_size(num_frames=1)
        step = (self.receptive_field_center(frame=1)
                - self.receptive_field_center(frame=0))
        center = self.receptive_field_center(frame=0)
        return SlidingWindow(duration=size / self.sample_rate,
                             step=step / self.sample_rate,
                             start=(center - (size - 1) / 2)
                             / self.sample_rate)


# -- reference checkpoints ----------------------------------------------------

class _PickledObject:
    """Stand-in for a pickled reference class the port does not model (and
    for the reference ``Specifications``, read back by
    ``Specifications.from_checkpoint``)."""

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs

    def __setstate__(self, state):
        # a dict, or (dict, slots dict) for classes with __slots__
        for part in (state if isinstance(state, tuple) else (state,)):
            if isinstance(part, dict):
                self.__dict__.update(part)


_PICKLED_CLASSES = {
    ("pyannote.audio.core.task", "Problem"): Problem,
    ("pyannote.audio.core.task", "Resolution"): Resolution,
    ("pyannote.audio.core.model", "Problem"): Problem,
    ("pyannote.audio.core.model", "Resolution"): Resolution,
}


class _ShimUnpickler(pickle.Unpickler):
    """Maps the reference's pickled ``Problem`` / ``Resolution`` onto the
    port's enums and any other ``pyannote.audio`` class onto a permissive
    container; everything else is found as usual."""

    def find_class(self, module, name):
        if (module, name) in _PICKLED_CLASSES:
            return _PICKLED_CLASSES[(module, name)]
        if module == "pyannote.audio" or module.startswith("pyannote.audio."):
            return _PickledObject
        return super().find_class(module, name)


class _ShimPickleModule:
    Unpickler = _ShimUnpickler
    load = staticmethod(lambda f, **kwargs: _ShimUnpickler(f).load())


def _pyannet(hparams: Dict[str, Any], specs) -> Dict[str, Any]:
    sincnet = dict(hparams.get("sincnet") or {})
    lstm = dict(hparams.get("lstm") or {})
    linear = dict(hparams.get("linear") or {})
    kwargs = {"sincnet_stride": sincnet.get("stride", 10),
              "sample_rate": hparams.get("sample_rate", 16000),
              "lstm_hidden": lstm.get("hidden_size", 128),
              "lstm_layers": lstm.get("num_layers", 2),
              "bidirectional": lstm.get("bidirectional", True),
              "linear_hidden": linear.get("hidden_size", 128),
              "linear_layers": linear.get("num_layers", 2)}
    if specs is not None:
        kwargs["specifications"] = Specifications.from_checkpoint(specs)
    return kwargs


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _wespeaker(hparams: Dict[str, Any], specs) -> Dict[str, Any]:
    kwargs = {k: hparams[k] for k in ("sample_rate", "num_mel_bins",
                                      "frame_length", "frame_shift",
                                      "window_type", "embed_dim",
                                      "m_channels") if k in hparams}
    if "num_blocks" in hparams:
        kwargs["num_blocks"] = tuple(hparams["num_blocks"])
    if "compute_dtype" in hparams:
        kwargs["compute_dtype"] = _DTYPES[hparams["compute_dtype"]]
    return kwargs


def _xvector(hparams: Dict[str, Any], specs) -> Dict[str, Any]:
    return {k: hparams[k] for k in ("sample_rate", "mfcc", "sincnet",
                                    "dimension") if k in hparams}


def _sseriouss(hparams: Dict[str, Any], specs) -> Dict[str, Any]:
    kwargs = {k: hparams[k] for k in ("wav2vec", "wav2vec_layer",
                                      "freeze_wav2vec", "lstm", "linear",
                                      "sample_rate") if k in hparams}
    if specs is not None:
        kwargs["specifications"] = Specifications.from_checkpoint(specs)
    return kwargs


def _totatonet(hparams: Dict[str, Any], specs) -> Dict[str, Any]:
    kwargs = {k: hparams[k] for k in ("encoder_decoder", "linear", "diar",
                                      "dprnn", "sample_rate", "n_sources",
                                      "wavlm_frozen", "wavlm_config")
              if k in hparams}
    # without a config, the WavLM branch is read off the checkpoint's
    # wavlm.* weights (ToTaToNet.load_reference_state_dict)
    kwargs["use_wavlm"] = bool(hparams.get("use_wavlm")) and \
        hparams.get("wavlm_config") is not None
    if specs is not None:
        kwargs["specifications"] = Specifications.from_checkpoint(specs)
    return kwargs


def _debug(hparams: Dict[str, Any], specs) -> Dict[str, Any]:
    kwargs = {k: hparams[k] for k in ("sample_rate",) if k in hparams}
    if specs is not None:
        kwargs["specifications"] = Specifications.from_checkpoint(specs)
    return kwargs


def _debug_embedding(hparams: Dict[str, Any], specs) -> Dict[str, Any]:
    return {k: hparams[k] for k in ("sample_rate",) if k in hparams}


_WESPEAKER = "pyannote_audio_tpu_torch.models.embedding.wespeaker"
_XVECTOR = "pyannote_audio_tpu_torch.models.embedding.xvector"

# architecture class name -> (module, class, hyper-parameters -> the
# port's constructor arguments)
_ARCHITECTURES = {
    "PyanNet": ("pyannote_audio_tpu_torch.models.segmentation.pyannet",
                "PyanNet", _pyannet),
    "SSeRiouSS": ("pyannote_audio_tpu_torch.models.segmentation.sseriouss",
                  "SSeRiouSS", _sseriouss),
    "ToTaToNet": ("pyannote_audio_tpu_torch.models.separation.totatonet",
                  "ToTaToNet", _totatonet),
    "SimpleSegmentationModel": (
        "pyannote_audio_tpu_torch.models.segmentation.debug",
        "SimpleSegmentationModel", _debug),
    "SimpleEmbeddingModel": (
        "pyannote_audio_tpu_torch.models.embedding.debug",
        "SimpleEmbeddingModel", _debug_embedding),
    "XVectorMFCC": (_XVECTOR, "XVectorMFCC", _xvector),
    "XVectorSincNet": (_XVECTOR, "XVectorSincNet", _xvector),
    **{f"WeSpeakerResNet{depth}": (_WESPEAKER, f"WeSpeakerResNet{depth}",
                                   _wespeaker)
       for depth in (18, 34, 50, 101, 152, 221, 293)},
}

# buffers a reference state dict may carry that the port derives itself
# (the sinc filterbank's tap grid and window)
_DERIVED_BUFFERS = (".filterbank.n_", ".filterbank.window_")


def _checkpoint_file(checkpoint: Union[str, Path],
                     subfolder: Optional[str]) -> Path:
    path = Path(checkpoint)
    if subfolder:
        path = path / subfolder
    if path.is_dir():
        path = path / CHECKPOINT
    if not path.is_file():
        raise ValueError(
            f"{checkpoint} (subfolder {subfolder!r}) holds no {CHECKPOINT}: "
            f"this package loads local checkpoints only (it has no hub "
            f"access)")
    return path


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """The dict of a reference-layout checkpoint file, with pickled
    reference classes read through the shim."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_ShimPickleModule)


def model_from_checkpoint(checkpoint: Mapping, **overrides) -> nn.Module:
    """Build the architecture a checkpoint dict names and load its
    weights; ``overrides`` replace constructor arguments (for example
    ``compute_dtype=torch.float32``). The module comes back on the CPU in
    eval mode."""
    vendor = checkpoint.get("pyannote.audio") or {}
    name = (vendor.get("architecture") or {}).get("class")
    if name not in _ARCHITECTURES:
        raise ValueError(f"architecture {name!r} is not ported yet (ported: "
                         f"{sorted(_ARCHITECTURES)})")
    module_name, class_name, to_kwargs = _ARCHITECTURES[name]
    Klass = getattr(importlib.import_module(module_name), class_name)
    hparams = {k: v for k, v in (checkpoint.get("hyper_parameters")
                                 or {}).items() if k != "task"}
    kwargs = to_kwargs(hparams, vendor.get("specifications"))
    kwargs.update(overrides)
    model = Klass(**kwargs)
    state = {k: v for k, v in checkpoint.get("state_dict", {}).items()
             if not k.endswith(_DERIVED_BUFFERS)}
    for key in model.state_dict():
        if key.endswith("num_batches_tracked"):
            state.setdefault(key, torch.tensor(0))
    return model.load_reference_state_dict(state).eval()


class Model:
    """``Model.from_pretrained``, as the JAX package names it."""

    @staticmethod
    def from_pretrained(checkpoint: Union[str, Path],
                        subfolder: Optional[str] = None,
                        **overrides) -> nn.Module:
        """Load a reference-layout ``pytorch_model.bin``: the file itself,
        or a directory (``/subfolder``) holding one. ``token``,
        ``cache_dir`` and ``revision`` are dropped (no hub access)."""
        for key in ("token", "use_auth_token", "cache_dir", "revision"):
            overrides.pop(key, None)
        return model_from_checkpoint(
            load_checkpoint(_checkpoint_file(checkpoint, subfolder)),
            **overrides)
