"""Reference-layout checkpoints and PLDA files, written by the benchmark
from the weights it drew, for the program to load as users load a
snapshot.

A checkpoint is pyannote.audio's ``pytorch_model.bin`` layout:
``{"state_dict": float32 tensors, "hyper_parameters": ...,
"pyannote.audio": {"architecture": {"module", "class"},
"specifications": ...}}``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch



def write_checkpoint(state: Dict[str, torch.Tensor], architecture: str,
                     hparams: dict, specifications: Optional[dict],
                     directory: Path) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    vendor = {"architecture": {"module": "pyannote.audio",
                               "class": architecture}}
    if specifications is not None:
        vendor["specifications"] = dict(specifications)
    tensors = {}
    for name, value in state.items():
        tensors[name] = value.detach().cpu().clone()
        if name.endswith("running_var"):
            tensors[name.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(0, dtype=torch.int64)
    path = directory / "pytorch_model.bin"
    torch.save({"state_dict": tensors, "hyper_parameters": dict(hparams),
                "pyannote.audio": vendor}, path)
    return path


def write_plda(arrays: Dict[str, np.ndarray], directory: Path) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    np.savez(directory / "xvec_transform.npz", mean1=arrays["mean1"],
             mean2=arrays["mean2"], lda=arrays["lda"])
    np.savez(directory / "plda.npz", mu=arrays["mu"], tr=arrays["tr"],
             psi=arrays["psi"])
