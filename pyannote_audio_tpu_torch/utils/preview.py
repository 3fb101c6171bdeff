"""Notebook preview helpers: listen to and visualize annotations.

Counterpart of pyannote_audio_tpu/utils/preview.py: ``listen`` returns an
IPython Audio widget (the waveform and its rate without IPython),
``preview`` draws a matplotlib timeline figure, ``preview_video``
animates one into a GIF (or a video through the ``ffmpeg`` binary).
matplotlib and IPython are optional and imported when called: without
matplotlib, ``preview`` and ``preview_video`` raise ``ImportError``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..core.annotation import Annotation, Timeline
from ..core.io import Audio, AudioFile
from ..core.segment import Segment, SlidingWindowFeature


def listen(audio_file: AudioFile, segment: Optional[Segment] = None):
    """Play (a crop of) an audio file in a notebook."""
    audio = Audio(sample_rate=16000, mono="downmix")
    if segment is None:
        waveform, sample_rate = audio(audio_file)
    else:
        waveform, sample_rate = audio.crop(audio_file, segment)
    try:
        from IPython.display import Audio as IPythonAudio
        return IPythonAudio(waveform[0], rate=sample_rate, autoplay=False)
    except ImportError:
        return waveform, sample_rate


def preview(
    audio_file: AudioFile,
    segment: Optional[Segment] = None,
    *annotations: Union[Annotation, Timeline, SlidingWindowFeature],
):
    """Render waveform + annotations as a matplotlib figure."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as exc:
        raise ImportError("preview requires matplotlib") from exc

    audio = Audio(sample_rate=16000, mono="downmix")
    if segment is None:
        waveform, sample_rate = audio(audio_file)
        segment = Segment(0, waveform.shape[1] / sample_rate)
    else:
        waveform, sample_rate = audio.crop(audio_file, segment)

    rows = 1 + len(annotations)
    fig, axes = plt.subplots(rows, 1, figsize=(10, 1.6 * rows),
                             sharex=True, squeeze=False)
    t = segment.start + np.arange(waveform.shape[1]) / sample_rate
    axes[0][0].plot(t, waveform[0], linewidth=0.3, color="gray")
    axes[0][0].set_ylabel("waveform")

    for i, ann in enumerate(annotations, start=1):
        ax = axes[i][0]
        if isinstance(ann, SlidingWindowFeature):
            window = ann.sliding_window
            times = [window[j].middle for j in range(len(ann.data))]
            ax.plot(times, ann.data, linewidth=0.8)
            ax.set_ylabel("scores")
            continue
        if isinstance(ann, Timeline):
            tmp = Annotation(uri=ann.uri)
            for seg in ann:
                tmp[seg, tmp.new_track(seg)] = "_"
            ann = tmp
        labels = ann.labels()
        for seg, _, label in ann.itertracks(yield_label=True):
            y = labels.index(label)
            ax.plot([seg.start, seg.end], [y, y], linewidth=6,
                    solid_capstyle="butt")
        ax.set_yticks(range(len(labels)))
        ax.set_yticklabels([str(label) for label in labels])
    axes[-1][0].set_xlabel("time (s)")
    axes[-1][0].set_xlim(segment.start, segment.end)
    fig.tight_layout()
    return fig


def preview_video(
    audio_file: AudioFile,
    segment: Optional[Segment] = None,
    zoom: float = 10.0,
    video_fps: int = 5,
    video_ext: str = "gif",
    display: bool = True,
    **views: Union[Annotation, Timeline, SlidingWindowFeature],
):
    """Animated preview: named views + waveform with a sliding zoom
    window and a time cursor.

    Parity: preview (reference utils/preview.py:92-260) — same
    signature and view semantics (``**views`` keyed by display name,
    waveform as the last row, ``zoom``-second window centered on the
    cursor). The reference renders through moviepy/ffmpeg; here
    matplotlib.animation writes a GIF with the Pillow writer (always
    available), or webm/mp4/ogv through the ``ffmpeg`` binary when it
    is on PATH (the GIF fallback carries no audio track).

    Returns an IPython display object when ``display`` is True (and
    IPython is importable), else the path to the rendered file.
    """
    import shutil
    import tempfile
    import warnings
    from pathlib import Path

    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    from collections.abc import Mapping
    if isinstance(audio_file, Mapping) and "uri" in audio_file:
        uri = str(audio_file["uri"])
    elif isinstance(audio_file, (str, Path)):
        uri = Path(audio_file).name
    else:
        uri = "preview"

    have_ffmpeg = shutil.which("ffmpeg") is not None
    if video_ext != "gif" and not have_ffmpeg:
        warnings.warn(
            f"'{video_ext}' output needs the ffmpeg binary, which is not "
            "on PATH; writing an animated GIF (no audio track) instead.")
        video_ext = "gif"

    audio = Audio(sample_rate=16000, mono="downmix")
    if segment is None:
        waveform, sample_rate = audio(audio_file)
        segment = Segment(0, waveform.shape[1] / sample_rate)
    else:
        waveform, sample_rate = audio.crop(audio_file, segment)
    zoom = min(zoom, segment.duration)

    # one row per view + the waveform row (reference row order)
    nrows = len(views) + 1
    fig, axes = plt.subplots(nrows, 1, figsize=(10, 2 * nrows),
                             sharex=True, squeeze=False)
    t = segment.start + np.arange(waveform.shape[1]) / sample_rate
    ax_wav = axes[-1][0]
    ax_wav.plot(t, waveform[0], linewidth=0.3, color="gray")
    ax_wav.set_ylabel("waveform")
    ax_wav.set_xlabel("time (s)")

    for ax_row, (name, view) in zip(axes[:-1], views.items()):
        ax = ax_row[0]
        if isinstance(view, SlidingWindowFeature):
            window = view.sliding_window
            times = [window[j].middle for j in range(len(view.data))]
            ax.plot(times, view.data, linewidth=0.8)
            ax.set_ylim(-0.1, 1.1)
        else:
            if isinstance(view, Timeline):
                tmp = Annotation(uri=view.uri)
                for seg in view:
                    tmp[seg, tmp.new_track(seg)] = "_"
                view = tmp
            labels = view.labels()
            for seg, _, label in view.itertracks(yield_label=True):
                y = labels.index(label)
                ax.plot([seg.start, seg.end], [y, y], linewidth=6,
                        solid_capstyle="butt")
            ax.set_yticks(range(len(labels)))
            ax.set_yticklabels([str(label) for label in labels])
        ax.set_ylabel(name)

    # animate by sliding the shared x-window and a cursor per row
    # (artists are drawn once; only limits + cursor positions change)
    cursors = [ax_row[0].axvline(segment.start, color="red", linewidth=1)
               for ax_row in axes]
    num_frames = max(2, int(round(segment.duration * video_fps)))

    def update(frame: int):
        T = segment.start + frame / video_fps
        half = zoom / 2
        left = min(max(T - half, segment.start), segment.end - zoom)
        for ax_row in axes:
            ax_row[0].set_xlim(left, left + zoom)
        for cursor in cursors:
            cursor.set_xdata([T, T])
        return cursors

    anim = animation.FuncAnimation(fig, update, frames=num_frames,
                                   blit=False)
    temp_dir = tempfile.mkdtemp(prefix="pyannote-tpu-preview")
    video_path = f"{temp_dir}/{uri}.{video_ext}"
    if video_ext == "gif":
        anim.save(video_path, writer=animation.PillowWriter(fps=video_fps))
    else:
        # ffmpeg binary available: render frames, then mux the audio in
        silent = f"{temp_dir}/{uri}.silent.{video_ext}"
        anim.save(silent, writer=animation.FFMpegWriter(fps=video_fps))
        wav_path = f"{temp_dir}/{uri}.wav"
        from ..core.io import write_wav
        write_wav(wav_path, waveform, sample_rate)
        import subprocess
        done = subprocess.run(
            ["ffmpeg", "-y", "-i", silent, "-i", wav_path,
             "-shortest", video_path],
            capture_output=True)
        if done.returncode != 0:
            warnings.warn("audio muxing failed; returning silent video")
            video_path = silent
    plt.close(fig)

    if display:
        try:
            if video_ext == "gif":
                from IPython.display import Image
                return Image(filename=video_path)
            from IPython.display import Video
            return Video(video_path, embed=True)
        except ImportError:
            warnings.warn("IPython is not installed; returning the path")
    return video_path
