"""Resolve models, PLDA, calibrations and pipelines from instances or
local checkpoints, and pick CUDA devices.

Counterpart of ``get_model``, ``get_plda``, ``get_pipeline``,
``get_calibration`` and ``get_devices`` of
pyannote_audio_tpu/pipelines/utils/getter.py. An instance comes back as
it is; a path, a hub id or a ``{"checkpoint": ..., "subfolder": ...}``
dict (what ``$model/...`` config placeholders expand to, with any
``revision``, ``token`` and ``cache_dir``) is loaded from the local disk
or resolved through ``utils/hf_hub.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Mapping, Union

import torch
from torch import nn

from ...core.calibration import CALIBRATION_FILE, Calibration
from ...core.model import Model
from ...core.plda import PLDA

PipelineModel = Union[nn.Module, str, Path, Mapping]

def _hub_arguments(spec, token=None, cache_dir=None) -> dict:
    """The hub keywords of a ``{checkpoint, ...}`` dict, the caller's
    ``token`` and ``cache_dir`` where it has none."""
    spec = spec if isinstance(spec, Mapping) else {}
    return {"revision": spec.get("revision"),
            "token": spec.get("token") or token,
            "cache_dir": spec.get("cache_dir") or cache_dir}


def get_model(model: PipelineModel, token=None,
              cache_dir=None) -> nn.Module:
    """A model instance, or one loaded from a reference-layout checkpoint
    (a ``pytorch_model.bin``, a directory holding one, a hub id, or a
    ``{checkpoint, subfolder}`` dict)."""
    if isinstance(model, nn.Module):
        return model
    hub = _hub_arguments(model, token, cache_dir)
    if isinstance(model, Mapping):
        return Model.from_pretrained(model["checkpoint"],
                                     subfolder=model.get("subfolder"), **hub)
    return Model.from_pretrained(model, **hub)


def get_plda(plda, token=None, cache_dir=None) -> PLDA:
    """A PLDA instance, or one loaded from a directory, a hub id (or a
    ``{checkpoint, subfolder}`` dict) holding its two npz files."""
    if plda is None:
        raise ValueError(
            "VBx clustering requires a PLDA: pass plda=<directory holding "
            "xvec_transform.npz and plda.npz> to the pipeline")
    if isinstance(plda, PLDA):
        return plda
    hub = _hub_arguments(plda, token, cache_dir)
    if isinstance(plda, Mapping):
        return PLDA.from_pretrained(plda["checkpoint"],
                                    subfolder=plda.get("subfolder") or "",
                                    **hub)
    return PLDA.from_pretrained(plda, **hub)


def get_pipeline(pipeline, **kwargs):
    """A pipeline instance, or one built by ``Pipeline.from_pretrained``
    (``kwargs`` go to it)."""
    from ...core.pipeline import Pipeline
    if isinstance(pipeline, Pipeline):
        return pipeline
    return Pipeline.from_pretrained(pipeline, **kwargs)


def get_calibration(calibration) -> Calibration:
    """A ``Calibration`` instance, or one loaded from a
    ``calibration.safetensors`` file, a directory holding one, a hub id,
    or a ``{checkpoint, subfolder}`` dict."""
    if isinstance(calibration, Calibration):
        return calibration
    if isinstance(calibration, Mapping):
        path = Path(calibration["checkpoint"])
        if path.exists():
            if calibration.get("subfolder"):
                path = path / calibration["subfolder"]
            return Calibration.from_file(path / CALIBRATION_FILE)
        return Calibration.from_pretrained(
            calibration["checkpoint"], subfolder=calibration.get("subfolder"),
            **_hub_arguments(calibration))
    if Path(calibration).is_file():
        return Calibration.from_file(calibration)
    return Calibration.from_pretrained(calibration)


def get_devices(needs: int = 1) -> List[torch.device]:
    """``needs`` CUDA devices, round-robin over the cards there are;
    without a card this raises (there is no CPU list)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("get_devices needs a CUDA device and none is "
                           "available")
    return [torch.device("cuda", i % count) for i in range(needs)]
