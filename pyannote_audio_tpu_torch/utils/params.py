"""Config merging (counterpart of pyannote_audio_tpu/utils/params.py)."""

from typing import Dict, Optional


def merge_dict(defaults: Dict, custom: Optional[Dict] = None) -> Dict:
    """A copy of ``defaults`` updated with ``custom`` (if any)."""
    merged = dict(defaults)
    if custom is not None:
        merged.update(custom)
    return merged
