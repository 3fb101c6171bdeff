"""PyTorch/CUDA port of pyannote_audio_tpu.

The JAX package beside this one is the reference; this package mirrors
its module paths. It imports ``torch`` and never ``jax``. The LSTM
recurrence, the one Pallas TPU kernel on the diarization path, is a CUDA
kernel here (``csrc/lstm_recurrence.cu``), built with ``nvcc`` at its
first CUDA launch.

    from pyannote_audio_tpu_torch import Pipeline
    pipeline = Pipeline.from_pretrained("path/to/snapshot", device="cuda")
    output = pipeline("audio.wav")

``Pipeline`` and ``Model`` are imported on first access.
"""

__version__ = "0.1.0"

_LAZY = {"Pipeline": ".core.pipeline", "Model": ".core.model"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
