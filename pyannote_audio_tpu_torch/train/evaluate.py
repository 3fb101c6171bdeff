"""The validation step: one forward, the DER components of a batch.

Counterpart of pyannote_audio_tpu/train/evaluate.py. One forward under
``torch.no_grad`` gives, from the same log-probs, the hard components at
threshold 0.5 (the powerset argmax decode, for ``der/val`` and its
family) and the soft ones at a 51-threshold sweep (the per-class
marginals ``exp(log_probs) @ mapping``, for ``der/val/optimal``). A
padded batch item carries ``valid = 0``, which zeroes its predictions and
targets, so it adds nothing to any component at any threshold. The
outputs stay on the device.

Under data parallelism each rank runs the step on its slice of the
padded batch; the components are pure sums, so the streaming metrics
that accumulate them sum them over the ranks with one ``sync`` at the
end of the validation (the JAX step's ``merge_psum`` under
``shard_map``, torchmetrics' ``dist_reduce_fx="sum"``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..metrics.streaming import (DEFAULT_THRESHOLDS, _pad_speakers,
                                 der_components)

__all__ = ["DEFAULT_THRESHOLDS", "make_eval_step", "pad_eval_batch"]


def make_eval_step(model: torch.nn.Module, powerset=None,
                   thresholds: np.ndarray = DEFAULT_THRESHOLDS) -> Callable:
    """(X, y, valid) device tensors -> (hard4, softpacked, output):

      hard4      (4,)       [fa, miss, conf, total] at threshold 0.5 on
                            the hard multilabel decode
      softpacked (3T + 1,)  [fa (T,), miss (T,), conf (T,), total] on the
                            soft per-class marginals
      output                the model's output (the first of a
                            multi-task model's), for the loss
    """
    def step(X: torch.Tensor, y: torch.Tensor, valid: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            output = model(X)
            if isinstance(output, (tuple, list)):
                output = output[0]
            if powerset is not None:
                hard = powerset.to_multilabel(output).float()
                soft = powerset.to_multilabel(output, soft=True)
            else:
                hard = soft = output.float()
            n = min(hard.shape[1], y.shape[1])
            v = valid.float()[:, None, None]
            target = y[:, :n].float() * v
            hard_p, y_hard = _pad_speakers(hard[:, :n] * v, target)
            soft_p, y_soft = _pad_speakers(soft[:, :n] * v, target)
            return (der_components(hard_p, y_hard, [0.5]),
                    der_components(soft_p, y_soft, thresholds), output)
    return step


def pad_eval_batch(X: np.ndarray, y: np.ndarray, batch_size: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad a ragged tail batch to ``batch_size``, with its validity
    mask."""
    n = len(X)
    valid = np.zeros(batch_size, np.float32)
    valid[:n] = 1.0
    if n == batch_size:
        return X, y, valid
    pad_X = np.zeros((batch_size - n,) + X.shape[1:], X.dtype)
    pad_y = np.zeros((batch_size - n,) + y.shape[1:], y.dtype)
    return (np.concatenate([X, pad_X]), np.concatenate([y, pad_y]), valid)
