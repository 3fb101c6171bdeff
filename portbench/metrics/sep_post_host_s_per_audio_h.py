"""Host seconds per hour of audio in ``SpeechSeparation.apply`` after
``_separate`` returns (embedding, clustering, reconstruction, the
overlap-add and its copy, leakage removal, normalisation), from the span
the benchmark sets from there to the end of ``apply``, over the traced
run's lists that ran without a profile."""


def read(trace):
    spans = trace["spans"]
    if spans["audio_s"] <= 0 or "post" not in spans["seconds"]:
        return None
    return spans["seconds"]["post"] / (spans["audio_s"] / 3600.0)
