"""Guards against TF32 silently changing float32 results.

Counterpart of pyannote_audio_tpu/utils/reproducibility.py, in torch's
own terms: on a CUDA device torch may run float32 matmuls
(``torch.backends.cuda.matmul.allow_tf32``, set by
``torch.set_float32_matmul_precision``) and cuDNN convolutions
(``torch.backends.cudnn.allow_tf32``, on by default) in TF32, with a
10-bit mantissa. ``fix_reproducibility`` pins both to float32 and warns
once, ``lower_precision_for_speed`` allows TF32 on both again,
``raise_reproducibility`` and ``warn_reproducibility`` act on a CUDA
device while either is allowed, never on the CPU. As in the JAX package,
no pipeline calls them: the port pins float32 at its own float32 sites
(``utils/runtime.py`` ``exact_float32``), whatever these flags say.
"""

from __future__ import annotations

import os
import warnings

import torch

_WARNED = [False]


class ReproducibilityError(Exception):
    pass


class ReproducibilityWarning(UserWarning):
    pass


def fix_reproducibility(precision=None) -> None:
    """Set torch's float32 matmul precision to ``precision`` ("highest",
    "high" or "medium") and allow cuDNN's TF32 only below "highest",
    warning once when that changes a flag. Without ``precision`` it is a
    no-op unless ``PYANNOTE_TPU_STRICT_REPRO=1``, which pins "highest"."""
    if precision is None:
        if os.environ.get("PYANNOTE_TPU_STRICT_REPRO", "0") != "1":
            return
        precision = "highest"
    current = (torch.get_float32_matmul_precision(),
               torch.backends.cudnn.allow_tf32)
    wanted = (precision, precision != "highest")
    if current != wanted:
        if not _WARNED[0]:
            warnings.warn(
                f"Setting torch's float32 matmul precision to {precision!r} "
                f"and cudnn.allow_tf32 to {wanted[1]} for reproducible "
                f"inference (were {current[0]!r} and {current[1]}). Set "
                "them yourself to silence this warning.",
                ReproducibilityWarning)
            _WARNED[0] = True
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = wanted[1]


def lower_precision_for_speed() -> None:
    """Allow TF32 for float32 matmuls and cuDNN convolutions (faster, on a
    CUDA device)."""
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True


def _low_precision_matmuls(device=None) -> bool:
    """Is TF32 allowed for matmuls or cuDNN convolutions on ``device`` (a
    ``torch.device``, a device string, or None for the CUDA card when
    there is one)? Never on the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type != "cuda":
        return False
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


_GUIDANCE = (
    "TF32 is allowed for float32 matmuls or cuDNN convolutions on this "
    "CUDA device (torch.backends.cuda.matmul.allow_tf32 or "
    "torch.backends.cudnn.allow_tf32). Call\n"
    "   >>> from pyannote_audio_tpu_torch.utils.reproducibility import "
    "fix_reproducibility\n"
    "   >>> fix_reproducibility('highest')\n"
    "or set PYANNOTE_TPU_STRICT_REPRO=1 for float32 math (slower), or you "
    "might face reproducibility issues and obtain slightly different "
    "results across devices.")


def raise_reproducibility(device=None) -> None:
    """Raise ``ReproducibilityError`` while TF32 is allowed on a CUDA
    ``device``."""
    if _low_precision_matmuls(device):
        raise ReproducibilityError(_GUIDANCE)


def warn_reproducibility(device=None) -> None:
    """Warn (``ReproducibilityWarning``) while TF32 is allowed on a CUDA
    ``device``."""
    if _low_precision_matmuls(device):
        warnings.warn(ReproducibilityWarning(_GUIDANCE))
