"""Checkpoint asset resolution: local snapshots + Huggingface Hub download.

Counterpart of pyannote_audio_tpu/utils/hf_hub.py, with its resolution
order, environment, URL scheme, cache layout, token handling and errors.
The port's loaders read the reference's assets, so ``AssetFileName.Model``
is ``pytorch_model.bin`` here (the JAX package's is ``params.msgpack``).
Resolution order:

1. a local path (absolute/relative) used directly;
2. local snapshot roots listed in ``PYANNOTE_TPU_HUB`` (colon-separated,
   like a model cache — point it at an artifact-store mount in
   deployments without egress);
3. an HTTP download from the hub's standard
   ``{endpoint}/{model_id}/resolve/{revision}/{file}`` url into a local
   cache (endpoint injectable via HF_ENDPOINT for mirrors and offline
   tests; reference delegates this step to huggingface_hub).
"""

from __future__ import annotations

import http.client
import os
import re
import urllib.error
import urllib.request
import uuid
from enum import Enum
from pathlib import Path
from typing import Optional, Union


class AssetFileName(Enum):
    Calibration = "calibration.safetensors"
    Model = "pytorch_model.bin"
    Pipeline = "config.yaml"

    def __str__(self) -> str:
        return self.value


def looks_like_hub_id(model_id: str) -> bool:
    """True for "name" / "org/name" shapes; False for filesystem-looking
    strings (absolute/relative paths). Bare names resolve only against
    local snapshot roots; the NETWORK download additionally requires the
    two-segment org/name shape (see download_from_hf_hub) so a typo'd
    local path never turns into a hub HTTP attempt."""
    return bool(re.fullmatch(r"[\w.-]+(?:/[\w.-]+)?", str(model_id))) \
        and not str(model_id).startswith(".")


def hub_roots() -> list:
    roots = os.environ.get("PYANNOTE_TPU_HUB", "")
    return [Path(r) for r in roots.split(":") if r]


def hub_endpoint() -> str:
    return os.environ.get("HF_ENDPOINT", "https://huggingface.co") \
        .rstrip("/")


def hub_cache_dir() -> Path:
    return Path(os.environ.get(
        "PYANNOTE_TPU_CACHE",
        Path.home() / ".cache" / "pyannote-tpu" / "hub"))


def resolve_checkpoint(model_id: Union[str, Path],
                       subfolder: Optional[str] = None,
                       revision: Optional[str] = None) -> Path:
    """Resolve a model id to a local directory.

    Accepts absolute/relative paths directly; otherwise searches the
    PYANNOTE_TPU_HUB roots, then the download cache, for
    ``<root>/<model_id>``.
    """
    path = Path(model_id)
    if path.exists():
        return path / subfolder if subfolder else path
    candidates = [root / str(model_id) for root in hub_roots()]
    candidates.append(
        hub_cache_dir() / str(model_id).replace("/", "--")
        / (revision or "main"))
    for candidate in candidates:
        if candidate.exists():
            return candidate / subfolder if subfolder else candidate
    raise FileNotFoundError(
        f"cannot resolve checkpoint {model_id!r} "
        f"(searched PYANNOTE_TPU_HUB={hub_roots()} and the download "
        f"cache); use download_from_hf_hub or place a local snapshot "
        "directory there.")


def _http_download(model_id: str, filename: str,
                   revision: Optional[str], token: Optional[str],
                   cache_dir: Optional[Path]) -> Path:
    """Fetch one asset via the hub resolve url into the local cache.

    Layout: ``<cache>/<org--repo>/<revision>/<filename>``; an existing
    cached file is reused without touching the network (parity role:
    huggingface_hub.hf_hub_download's cache)."""
    revision = revision or "main"
    cache_root = Path(cache_dir) if cache_dir else hub_cache_dir()
    target = cache_root / model_id.replace("/", "--") / revision / filename
    if target.exists():
        return target
    url = f"{hub_endpoint()}/{model_id}/resolve/{revision}/{filename}"
    request = urllib.request.Request(url)
    if token:
        request.add_header("Authorization", f"Bearer {token}")
    target.parent.mkdir(parents=True, exist_ok=True)
    # unique temp name: concurrent downloaders of the same asset must
    # not interleave into one .part file (whoever publishes last wins,
    # each with a complete copy)
    tmp = target.with_suffix(
        target.suffix + f".{os.getpid()}-{uuid.uuid4().hex[:8]}.part")
    # finite timeout: a stalled connection (proxy that accepts TCP but
    # never answers) must error out, not hang from_pretrained forever
    timeout = float(os.environ.get("PYANNOTE_TPU_HUB_TIMEOUT", "60"))
    try:
        with urllib.request.urlopen(request, timeout=timeout) \
                as response, open(tmp, "wb") as f:
            while True:
                chunk = response.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
            # a connection closed before its Content-Length is a torn
            # file, which http.client's read(amt) returns without an
            # error (the JAX package publishes it)
            if response.length:
                raise http.client.IncompleteRead(b"", response.length)
        tmp.replace(target)  # atomic publish: no torn files on interrupt
    finally:
        tmp.unlink(missing_ok=True)
    return target


def _ambient_hub_token() -> Optional[str]:
    """HF_TOKEN / HUGGING_FACE_HUB_TOKEN env vars or the cached CLI login
    token — the same ambient credentials huggingface_hub reads, so gated
    repos work without passing token= explicitly (reference delegates to
    hf_hub_download, which does this automatically)."""
    for var in ("HF_TOKEN", "HUGGING_FACE_HUB_TOKEN"):
        value = os.environ.get(var)
        if value:
            return value
    login = Path(os.environ.get(
        "HF_HOME", Path.home() / ".cache" / "huggingface")) / "token"
    try:
        value = login.read_text().strip()
        return value or None
    except OSError:
        return None


def download_from_hf_hub(model_id: str,
                         asset: Union[AssetFileName, str],
                         subfolder: Optional[str] = None,
                         revision: Optional[str] = None,
                         token: Optional[str] = None,
                         cache_dir=None) -> Path:
    """Resolve an asset file: local snapshot first, hub download second.

    Parity: download_from_hf_hub (reference hf_hub.py:44-104) incl. the
    pyannoteAI-key filter (a token not starting with "hf\\_" is never
    sent to the hub) and the gated-repo guidance on auth failures.
    """
    filename = asset.value if isinstance(asset, AssetFileName) else asset
    if isinstance(token, str) and not token.startswith("hf_"):
        token = None        # likely a pyannoteAI key (reference :75-77)
    if not token:
        token = _ambient_hub_token()
    try:
        directory = resolve_checkpoint(model_id, subfolder=subfolder,
                                       revision=revision)
        path = directory / filename
        if path.exists():
            return path
    except FileNotFoundError:
        pass
    if "/" not in str(model_id):
        # a bare name is far more likely a typo'd/missing local path than
        # a hub repo — never turn it into a network attempt (with no
        # egress that would hang until the urlopen timeout)
        raise FileNotFoundError(
            f"cannot resolve checkpoint {model_id!r}: not a local path, "
            f"not in the snapshot roots (PYANNOTE_TPU_HUB={hub_roots()}), "
            "and hub downloads need the org/name id shape")
    remote_name = f"{subfolder}/{filename}" if subfolder else filename
    try:
        return _http_download(str(model_id), remote_name, revision, token,
                              cache_dir)
    except urllib.error.HTTPError as error:
        if error.code == 404:
            raise FileNotFoundError(
                f"{remote_name} not found in hub repo {model_id!r} "
                f"(revision {revision or 'main'})") from error
        if error.code in (401, 403):
            asset_name = asset.name if isinstance(asset, AssetFileName) \
                else asset
            print(
                f"\nCould not download {asset_name} from {model_id}.\n"
                "It might be because the repository is private or "
                "gated:\n\n"
                f"* visit https://hf.co/{model_id} to accept user "
                "conditions\n"
                "* visit https://hf.co/settings/tokens to create an "
                "authentication token\n"
                f"* pass it with the `token` argument: "
                f"from_pretrained('{model_id}', token='hf_....')\n")
        raise
    except urllib.error.URLError as error:
        raise FileNotFoundError(
            f"cannot resolve checkpoint {model_id!r}: no local snapshot "
            f"(PYANNOTE_TPU_HUB={hub_roots()}) and the hub endpoint "
            f"{hub_endpoint()} is unreachable ({error.reason}); place a "
            "local snapshot directory there instead.") from error


def hub_asset(checkpoint: Union[str, Path], asset: Union[AssetFileName, str],
              subfolder: Optional[str] = None, revision: Optional[str] = None,
              token: Optional[str] = None, cache_dir=None) -> Optional[Path]:
    """``asset`` of ``checkpoint`` through ``download_from_hf_hub`` when
    it is no existing path but looks like a hub id; None otherwise (the
    caller reads the path itself). An unresolvable id raises
    ``ValueError`` naming both routes."""
    if Path(checkpoint).exists() or not looks_like_hub_id(str(checkpoint)):
        return None
    try:
        return download_from_hf_hub(str(checkpoint), asset,
                                    subfolder=subfolder or None,
                                    revision=revision, token=token,
                                    cache_dir=cache_dir)
    except (FileNotFoundError, urllib.error.HTTPError) as error:
        raise ValueError(
            f"{checkpoint} is not a local path and does not resolve as a "
            f"hub id: {error}") from error
