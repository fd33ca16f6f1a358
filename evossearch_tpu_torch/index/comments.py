"""Per-folder image comment store (component G).

Same on-disk contract as the reference (`.clip_index/comments.json`, a JSON
dict {absolute_image_path: ["[YYYY-MM-DD HH:MM:SS] text", ...]}; load at
oldapp.py:137-150, save at :152-165, append with server-side timestamp at
:172-186). Unlike the reference's unlocked read-modify-write, appends here
hold an OS file lock, so concurrent requests can't lose comments.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager
from datetime import datetime
from pathlib import Path

from ..utils import get_logger
from .store import index_dir

log = get_logger("index.comments")


def _comments_file(folder, index_folder_name: str = ".clip_index") -> Path:
    return index_dir(folder, index_folder_name) / "comments.json"


@contextmanager
def comments_lock(folder, index_folder_name: str = ".clip_index"):
    """Advisory exclusive lock guarding comments.json read-modify-write.

    The lock file is a SIBLING of the index dir (``.clip_index.comments.lock``)
    rather than inside it: IndexWriter.finalize swaps the whole index dir
    away during publish, and a lock living inside the swapped dir would
    protect nothing (a concurrent append could land in the doomed old dir
    and vanish). finalize() takes this same lock around the swap.
    """
    import fcntl

    lock_path = index_dir(folder, index_folder_name).with_name(
        index_folder_name + ".comments.lock"
    )
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def load_comments(folder, index_folder_name: str = ".clip_index") -> dict:
    """{} on missing/corrupt file (reference oldapp.py:142-150)."""
    try:
        return json.loads(
            _comments_file(folder, index_folder_name).read_text(encoding="utf-8")
        )
    except Exception:
        return {}


def save_comments(folder, data: dict, index_folder_name: str = ".clip_index") -> bool:
    try:
        f = _comments_file(folder, index_folder_name)
        f.parent.mkdir(exist_ok=True)
        tmp = f.with_suffix(".json.tmp")
        tmp.write_text(
            json.dumps(data, ensure_ascii=False, indent=2), encoding="utf-8"
        )
        tmp.replace(f)
        return True
    except Exception as e:
        log.warning("Error saving comments: %s", e)
        return False


def get_image_comments(
    folder, image_path: str, index_folder_name: str = ".clip_index"
) -> list[str]:
    return load_comments(folder, index_folder_name).get(image_path, [])


def add_image_comment(
    folder, image_path: str, comment: str, index_folder_name: str = ".clip_index"
) -> bool:
    """Append with the reference's timestamp format (oldapp.py:180-182)."""
    with comments_lock(folder, index_folder_name):
        data = load_comments(folder, index_folder_name)
        timestamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        data.setdefault(image_path, []).append(f"[{timestamp}] {comment}")
        return save_comments(folder, data, index_folder_name)
