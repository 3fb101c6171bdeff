"""Resolve models, PLDA and pipelines from instances or local checkpoints.

Counterpart of ``get_model``, ``get_plda`` and ``get_pipeline`` of
pyannote_audio_tpu/pipelines/utils/getter.py. An instance comes back as
it is; a path or a ``{"checkpoint": <dir>, "subfolder": ...}`` dict (what
``$model/...`` config placeholders expand to) is loaded from the local
disk. There is no hub access: an id that is not a local path raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Union

from torch import nn

from ...core.model import Model
from ...core.plda import PLDA

PipelineModel = Union[nn.Module, str, Path, Mapping]


def get_model(model: PipelineModel) -> nn.Module:
    """A model instance, or one loaded from a reference-layout checkpoint
    (a ``pytorch_model.bin``, a directory holding one, or a
    ``{checkpoint, subfolder}`` dict)."""
    if isinstance(model, nn.Module):
        return model
    if isinstance(model, Mapping):
        return Model.from_pretrained(model["checkpoint"],
                                     subfolder=model.get("subfolder"))
    return Model.from_pretrained(model)


def get_plda(plda) -> PLDA:
    """A PLDA instance, or one loaded from a directory (or a
    ``{checkpoint, subfolder}`` dict) holding its two npz files."""
    if plda is None:
        raise ValueError(
            "VBx clustering requires a PLDA: pass plda=<directory holding "
            "xvec_transform.npz and plda.npz> to the pipeline")
    if isinstance(plda, PLDA):
        return plda
    if isinstance(plda, Mapping):
        return PLDA.from_pretrained(plda["checkpoint"],
                                    subfolder=plda.get("subfolder") or "")
    return PLDA.from_pretrained(plda)


def get_pipeline(pipeline, **kwargs):
    """A pipeline instance, or one built by ``Pipeline.from_pretrained``
    (``kwargs`` go to it)."""
    from ...core.pipeline import Pipeline
    if isinstance(pipeline, Pipeline):
        return pipeline
    return Pipeline.from_pretrained(pipeline, **kwargs)
