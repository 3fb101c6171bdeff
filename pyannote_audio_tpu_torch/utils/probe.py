"""Feature taps on any model trunk.

Counterpart of pyannote_audio_tpu/utils/probe.py, which captures flax
intermediates: here ``register_forward_hook`` on the modules of
``named_modules()`` whose dotted name contains one of the targets. The
hooks live only for the call, so the model is left as it was.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch
from torch import nn


def probe(model: nn.Module, targets: Iterable[str]) -> Callable:
    """Build ``fn(waveforms) -> (output, {name: activation})``.

    ``targets`` are module-name substrings, e.g. ["lstm", "sincnet"]; an
    activation is the module's output (the first of a tuple, as an LSTM
    returns), detached, on the model's device. ``waveforms`` is an array
    or a tensor, moved to the model's device; the forward runs under
    ``torch.inference_mode``.
    """
    targets = list(targets)
    names = [name for name, _ in model.named_modules()
             if name and any(t in name for t in targets)]

    def fn(waveforms):
        captured: Dict[str, torch.Tensor] = {}
        modules = dict(model.named_modules())

        def hook_for(name):
            def hook(module, inputs, output):
                value = output[0] if isinstance(output, tuple) else output
                captured[name] = value.detach()
            return hook
        handles = [modules[name].register_forward_hook(hook_for(name))
                   for name in names]
        try:
            device = next(model.parameters()).device
            x = torch.as_tensor(waveforms, dtype=torch.float32).to(device)
            with torch.inference_mode():
                output = model(x)
        finally:
            for handle in handles:
                handle.remove()
        return output, captured

    return fn
