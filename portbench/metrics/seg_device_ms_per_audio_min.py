"""Device milliseconds per minute of audio of the kernels launched
inside the ``portbench.segmentation`` range (``Inference.slide``: the segmentation model over every chunk), from the profiler's link between a CPU op
and the kernels it launched, in the list traced with CPU ops."""


def read(trace):
    ranges = trace["ranges"]
    seconds = ranges["device_s"].get("segmentation", 0.0)
    if seconds <= 0 or ranges["audio_s"] <= 0:
        return None
    return seconds * 1e3 / (ranges["audio_s"] / 60.0)
