"""Host seconds in ``SpeakerDiarization._finalize`` (wait for the staged
copies, clustering, reconstruction, annotation) per hour of audio, from
the span the benchmark sets around it, over the traced run's lists that
ran without a profile."""


def read(trace):
    spans = trace["spans"]
    if spans["audio_s"] <= 0 or "finalize" not in spans["seconds"]:
        return None
    return spans["seconds"]["finalize"] / (spans["audio_s"] / 3600.0)
