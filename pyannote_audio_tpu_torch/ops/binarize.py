"""Hysteresis thresholding on the device that holds the scores.

Counterpart of pyannote_audio_tpu/ops/binarize.py. The recurrence
``state[t] = cmd[t] if cmd[t] != 0 else state[t - 1]`` (cmd: +1 above
onset, -1 below offset, 0 in between) is a forward-fill of the last
non-zero command; the JAX package runs it as an associative scan. Here it
is a running maximum (``cummax``) over the frame indices of the non-zero
commands, then a gather of the command at that index: O(T) work, no host
sync and no loop over frames.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

Threshold = Union[float, torch.Tensor]


def hysteresis(scores: torch.Tensor, onset: Threshold, offset: Threshold,
               initial_on: Optional[bool] = None) -> torch.Tensor:
    """Boolean activation with hysteresis along axis 0 of ``scores``
    (frames, ...).

    NaN becomes 0.0 first (a NaN run turns the state off rather than
    freezing it); an undecided frame 0 takes ``initial_on``, or when it
    is None the band's midpoint decision ``scores[0] >= (onset + offset)
    / 2``.
    """
    scores = torch.nan_to_num(scores)
    # the thresholds and the band's midpoint in the scores' precision, as
    # the JAX package computes them
    onset, offset = (torch.as_tensor(t, dtype=scores.dtype,
                                     device=scores.device)
                     for t in (onset, offset))
    one = torch.ones((), dtype=torch.int8, device=scores.device)
    cmd = torch.where(scores > onset, one,
                      torch.where(scores < offset, -one, 0 * one))
    if initial_on is None:
        init = scores[0] >= 0.5 * (onset + offset)
    else:
        init = torch.full(cmd.shape[1:], bool(initial_on),
                          device=scores.device)
    first = torch.where(cmd[0] == 0, torch.where(init, one, -one), cmd[0])
    cmd = torch.cat([first[None], cmd[1:]])
    frames = torch.arange(cmd.shape[0], device=scores.device).view(
        -1, *([1] * (cmd.ndim - 1)))
    # index of the last non-zero command at or before each frame (frame
    # 0's command is never zero). The scan runs along the innermost axis:
    # along an outer one, torch's CUDA scan walks each column in one
    # thread, one frame after another
    last = torch.where(cmd != 0, frames, 0).movedim(0, -1).contiguous() \
        .cummax(dim=-1).values.movedim(-1, 0)
    return cmd.gather(0, last) > 0
