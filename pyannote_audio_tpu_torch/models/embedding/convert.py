"""Convert a WeSpeaker checkpoint into a reference-layout checkpoint.

Counterpart of pyannote_audio_tpu/models/embedding/convert.py: an
upstream WeSpeaker ``avg_model.pt`` (its keys without the ``resnet.``
prefix) or a reference state dict (with it) becomes a directory holding a
reference-layout ``pytorch_model.bin`` (``utils.convert.
write_reference_checkpoint``) that ``Model.from_pretrained`` and
``PretrainedSpeakerEmbedding`` read. Keys the ResNet does not have (a
classification head) are dropped; a missing one raises.

Usage:
    python -m pyannote_audio_tpu_torch.models.embedding.convert \\
        avg_model.pt out_dir --architecture WeSpeakerResNet34
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def convert(checkpoint: str, into: str,
            architecture: str = "WeSpeakerResNet34", **model_kwargs) -> Path:
    """Write ``checkpoint``'s weights onto ``architecture`` (built with
    ``model_kwargs``, e.g. a narrower ``m_channels``) as a checkpoint
    directory ``into``; returns the written file."""
    import torch

    from ...utils.convert import write_reference_checkpoint
    from . import wespeaker

    model = getattr(wespeaker, architecture)(**model_kwargs)
    state = torch.load(checkpoint, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    state = {k: np.asarray(v) for k, v in state.items()
             if hasattr(v, "numpy")}
    if not any(k.startswith("resnet.") for k in state):
        state = {f"resnet.{k}": v for k, v in state.items()}
    wanted = model.state_dict()
    missing = sorted(k for k in wanted if k not in state
                     and not k.endswith("num_batches_tracked"))
    if missing:
        raise ValueError(f"{checkpoint} lacks {len(missing)} weights of "
                         f"{architecture}, e.g. {missing[:3]}")
    model.load_reference_state_dict({
        k: state.get(k, np.asarray(0, dtype=np.int64)) for k in wanted})
    path = write_reference_checkpoint(model.state_dict(), architecture,
                                      model.reference_hparams(), None, into)
    print(f"converted {checkpoint} -> {into}")
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint")
    parser.add_argument("into")
    parser.add_argument("--architecture", default="WeSpeakerResNet34")
    args = parser.parse_args(argv)
    convert(args.checkpoint, args.into, args.architecture)
    return 0


if __name__ == "__main__":
    sys.exit(main())
