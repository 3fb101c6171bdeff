"""Device milliseconds per minute of audio of the kernels launched
inside the ``portbench.dprnn`` range (the separation model's DPRNN
masker, ``model.masker.forward``: bottleneck, the intra- and inter-chunk
BiLSTMs with the recurrence kernel, their linears and gLNs, the output
convs), from the profiler's link between a CPU op and the kernels it
launched, in the list traced with CPU ops."""


def read(trace):
    ranges = trace["ranges"]
    seconds = ranges["device_s"].get("dprnn", 0.0)
    if seconds <= 0 or ranges["audio_s"] <= 0:
        return None
    return seconds * 1e3 / (ranges["audio_s"] / 60.0)
