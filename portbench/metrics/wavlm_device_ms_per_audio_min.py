"""Device milliseconds per minute of audio of the kernels launched
inside the ``portbench.wavlm`` range (the separation model's WavLM-large
branch, ``model.wavlm.forward``: its conv extractor, projection,
positional conv and 24 transformer layers), from the profiler's link
between a CPU op and the kernels it launched, in the list traced with CPU
ops."""


def read(trace):
    ranges = trace["ranges"]
    seconds = ranges["device_s"].get("wavlm", 0.0)
    if seconds <= 0 or ranges["audio_s"] <= 0:
        return None
    return seconds * 1e3 / (ranges["audio_s"] / 60.0)
