"""Model-name resolution: local path | HF-hub name | GGUF file.

Reference analogue: hub download + model resolution (reference:
lib/llm/src/hub.rs:126 `from_hf`, local_model.rs:39-100) — the reference
resolves `org/repo` through the HF hub cache and downloads when absent.
Here the same resolution order applies:

  1. an existing local path (directory or .gguf file) wins;
  2. `org/repo` is looked up in the HF hub cache
     (``$HF_HUB_CACHE`` | ``$HF_HOME/hub`` | ``~/.cache/huggingface/hub``,
     layout ``models--org--repo/snapshots/<commit>``) — the standard
     cache other tools populate;
  3. if absent and `huggingface_hub` is importable, it is downloaded
     (honors ``HF_HUB_OFFLINE``); otherwise a clear error explains how
     to pre-populate the cache (this image is zero-egress).
"""

from __future__ import annotations

import os
import re

from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("hub")

_HUB_NAME = re.compile(r"^[\w.-]+/[\w.-]+$")


def hub_cache_dir() -> str:
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.expanduser("~/.cache/huggingface/hub")


def _cached_snapshot(name: str, revision: str | None = None) -> str | None:
    """→ snapshot dir for a cached `org/repo`, or None.

    A pinned `revision` either resolves exactly or fails — silently
    serving different weights than pinned is never acceptable. The
    any-snapshot fallback applies only when nothing was pinned and the
    cache has no refs/main."""
    repo_dir = os.path.join(hub_cache_dir(), "models--" + name.replace("/", "--"))
    snaps = os.path.join(repo_dir, "snapshots")
    if not os.path.isdir(snaps):
        return None
    pinned = revision is not None
    if revision is None:
        # refs/main records the snapshot commit the way the hub cache does.
        ref = os.path.join(repo_dir, "refs", "main")
        if os.path.exists(ref):
            with open(ref) as f:
                revision = f.read().strip()
    if revision:
        cand = os.path.join(snaps, revision)
        if os.path.isdir(cand):
            return cand
        if pinned:
            # NOT a silent-fallback candidate: a pinned revision either
            # resolves exactly here or goes to the downloader (which
            # fetches exactly that revision) — never another snapshot.
            log.info("%s@%s not cached (have %s)", name, revision,
                     sorted(os.listdir(snaps)))
            return None
        log.warning("%s: refs/main points at missing snapshot %s", name, revision)
    commits = os.listdir(snaps)
    if commits:  # nothing pinned: any snapshot (newest mtime)
        commits.sort(key=lambda c: os.path.getmtime(os.path.join(snaps, c)))
        return os.path.join(snaps, commits[-1])
    return None


def is_gguf(path: str) -> bool:
    if path.endswith(".gguf") and os.path.isfile(path):
        return True
    if os.path.isfile(path):
        try:
            with open(path, "rb") as f:
                return f.read(4) == b"GGUF"
        except OSError:
            return False
    return False


def resolve_model(name_or_path: str, revision: str | None = None) -> str:
    """→ a local checkpoint path (HF directory or .gguf file).

    Raises FileNotFoundError with remediation steps when the name cannot
    be resolved offline and no downloader is available."""
    if os.path.exists(name_or_path):
        return name_or_path
    if not _HUB_NAME.match(name_or_path):
        raise FileNotFoundError(
            f"model path {name_or_path!r} does not exist and is not an "
            f"org/repo hub name"
        )
    cached = _cached_snapshot(name_or_path, revision)
    if cached is not None:
        log.info("resolved %s from hub cache: %s", name_or_path, cached)
        return cached
    pin = f"@{revision}" if revision else ""
    remedy = (
        f"{name_or_path}{pin!s} is not in the hub cache ({hub_cache_dir()}) — "
        f"pre-populate the cache (`huggingface-cli download {name_or_path}` "
        f"on a connected machine, then ship $HF_HOME) or pass a local path"
    )
    if os.environ.get("HF_HUB_OFFLINE") in ("1", "ON", "YES", "TRUE"):
        raise FileNotFoundError(remedy + " (HF_HUB_OFFLINE is set)")
    try:
        from huggingface_hub import snapshot_download  # type: ignore[import-not-found]
    except ImportError:
        raise FileNotFoundError(remedy) from None
    log.info("downloading %s from the hub", name_or_path)
    try:
        return snapshot_download(name_or_path, revision=revision)
    except Exception as e:  # noqa: BLE001 — zero-egress / auth / 404
        raise FileNotFoundError(f"hub download failed ({e}); {remedy}") from e
