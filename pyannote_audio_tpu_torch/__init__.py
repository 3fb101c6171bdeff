"""PyTorch/CUDA port of pyannote_audio_tpu.

The JAX package beside this one is the reference; this package mirrors
its module paths. It imports ``torch`` and never ``jax``. The LSTM
recurrence, the one Pallas TPU kernel on the diarization path, is a CUDA
kernel here (``csrc/lstm_recurrence.cu``), built with ``nvcc`` at its
first CUDA launch.

    from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \\
        SpeakerDiarization
"""

__version__ = "0.1.0"
