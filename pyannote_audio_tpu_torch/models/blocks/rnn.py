"""Multi-layer (bi)LSTM whose recurrence is the CUDA kernel on the card.

Counterpart of pyannote_audio_tpu/models/blocks/rnn.py. Parameters carry
torch.nn.LSTM's names and layout (``weight_ih_l{i}[_reverse]``, ...), so
reference checkpoints load verbatim. Each layer hoists both directions'
input projections into one matmul, then runs the recurrence through
``ops.lstm_kernel.LSTMRecurrence``. Its forward is
``lstm_bidirectional_recurrence``: one kernel launch per layer for CUDA
tensors, the plain PyTorch recurrence for CPU tensors. Its gradient,
where autograd records, is the float32 vector-Jacobian product of the
recurrence: one launch of the backward kernel per layer for CUDA tensors
(``lstm_recurrence_backward``), the plain version for CPU tensors; under
``no_grad`` / ``inference_mode`` it records nothing, so serving launches
and computes what the bare call does. The recurrent product runs at
``utils.runtime.lstm_precision`` (the JAX package's
PYANNOTE_TPU_LSTM_PRECISION on a CUDA device, float32 on the CPU). On the
card both kernels keep W_hh on chip up to H = 256 and stream it through
shared memory above (``ops.lstm_kernel.kernel_geometry`` and
``backward_geometry``): the forward takes any H up to 1792 ("default")
or 1408 ("high", "highest"), the backward up to 2048, where the JAX
module sends every ``H % 128 == 0`` to its Pallas kernel (a TPU lane
rule). The CPU path takes any.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.lstm_kernel import LSTMRecurrence, prepare_recurrent_weights
from ...utils.runtime import exact_float32, lstm_precision


class LSTM(nn.Module):
    """(B, T, D) -> (B, T, H * num_directions), batch first; trainable."""

    def __init__(self, input_size: int, hidden_size: int = 128,
                 num_layers: int = 2, bidirectional: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        H = hidden_size
        in_dim = input_size
        for i in range(num_layers):
            for suffix in self._suffixes():
                for name, shape in ((f"weight_ih_l{i}", (4 * H, in_dim)),
                                    (f"weight_hh_l{i}", (4 * H, H)),
                                    (f"bias_ih_l{i}", (4 * H,)),
                                    (f"bias_hh_l{i}", (4 * H,))):
                    self.register_parameter(
                        name + suffix, nn.Parameter(torch.empty(shape)))
            in_dim = H * len(self._suffixes())
        self.reset_parameters(generator)
        # per layer: (key, W_hh packed for the kernel), rebuilt when the
        # weights change in place, move, or the precision changes
        self._prepared = {}

    def _suffixes(self):
        return ("", "_reverse") if self.bidirectional else ("",)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch.nn.LSTM's init: U(-1/sqrt(H), 1/sqrt(H)) everywhere."""
        bound = self.hidden_size ** -0.5
        for p in self.parameters():
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        precision = lstm_precision(x.device)
        h = x.transpose(0, 1)                                 # (T, B, D)
        # the float32 input projection (and the plain recurrence's
        # products on the CPU) without TF32, as the JAX package pins
        # Precision.HIGHEST there
        with exact_float32():
            for i in range(self.num_layers):
                names = [f"l{i}{s}" for s in self._suffixes()]
                w_ih = torch.cat([getattr(self, f"weight_ih_{n}")
                                  for n in names])
                bias = torch.cat([getattr(self, f"bias_ih_{n}")
                                  + getattr(self, f"bias_hh_{n}")
                                  for n in names])
                w_hh = torch.stack([getattr(self, f"weight_hh_{n}")
                                    for n in names])
                xw = torch.matmul(h, w_ih.t()) + bias      # (T, B, D*4H)
                prepared = None
                if x.device.type == "cuda":
                    prepared = self._prepared_weights(i, names, w_hh,
                                                      precision)
                h = LSTMRecurrence.apply(xw.contiguous(), w_hh, precision,
                                         prepared)
        return h.transpose(0, 1)

    def _prepared_weights(self, layer, names, w_hh, precision):
        """Layer ``layer``'s W_hh packed for the kernel, cached on the
        parameters' versions and device and on the precision; packed from
        ``w_hh.detach()``, outside the graph (an optimizer's in-place
        step bumps the versions, so each training step packs afresh)."""
        key = (tuple((getattr(self, f"weight_hh_{n}")._version,
                      getattr(self, f"weight_hh_{n}").data_ptr())
                     for n in names), w_hh.device, precision)
        cached = self._prepared.get(layer)
        if cached is None or cached[0] != key:
            cached = (key, prepare_recurrent_weights(w_hh.detach(),
                                                     precision))
            self._prepared[layer] = cached
        return cached[1]
