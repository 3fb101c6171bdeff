"""Host seconds in ``SpeakerDiarization._stage`` (decode, upload,
queueing the file's device program) per hour of audio, from the span the
benchmark sets around it, over the traced run's lists that ran without a
profile."""


def read(trace):
    spans = trace["spans"]
    if spans["audio_s"] <= 0 or "stage" not in spans["seconds"]:
        return None
    return spans["seconds"]["stage"] / (spans["audio_s"] / 3600.0)
