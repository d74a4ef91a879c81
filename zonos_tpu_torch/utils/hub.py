"""Checkpoint discovery: local files only.

A file of a hub repository is looked up under the local models directory,
``$ZONOS_TPU_MODELS_DIR/<repo_id>/<filename>`` (default ``./models``), the
same variable and layout as the JAX package's, so one directory serves both.
Nothing is downloaded: a missing file raises ``FileNotFoundError`` naming the
path it was looked for at.
"""

from __future__ import annotations

import os
from pathlib import Path


def hub_download(repo_id: str, filename: str) -> str:
    """The local path of ``filename`` of ``repo_id``; raises
    ``FileNotFoundError`` when it is not there."""
    local = Path(os.environ.get("ZONOS_TPU_MODELS_DIR", "models")) / repo_id / filename
    if not local.is_file():
        raise FileNotFoundError(
            f"checkpoint file {filename!r} of {repo_id!r} not found at {local}; "
            f"place it under $ZONOS_TPU_MODELS_DIR/{repo_id}/ (no download is attempted)")
    return str(local)
