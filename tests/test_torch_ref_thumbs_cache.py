"""The port against tests/test_thumbs_cache.py: thumbnail cache:
hit/miss behavior, mtime invalidation, output contract.

Nothing to adapt: the package is renamed.
"""

import base64
import io
import time

import numpy as np
from PIL import Image

import evossearch_tpu_torch.server.thumbs as thumbs


def _img(path, color):
    Image.fromarray(np.full((600, 800, 3), color, np.uint8)).save(path, quality=95)


def test_cache_hit_and_mtime_invalidation(tmp_path, monkeypatch):
    p = tmp_path / "a.jpg"
    _img(p, 40)
    calls = []
    real_render = thumbs._render
    monkeypatch.setattr(
        thumbs, "_render", lambda *a: (calls.append(1), real_render(*a))[1]
    )
    t1 = thumbs.thumbnail_b64(str(p))
    t2 = thumbs.thumbnail_b64(str(p))
    assert t1 == t2 and len(calls) == 1  # second call served from cache

    # modified file -> new mtime -> re-render with new content
    time.sleep(0.02)
    _img(p, 200)
    t3 = thumbs.thumbnail_b64(str(p))
    assert len(calls) == 2 and t3 != t1

    img = Image.open(io.BytesIO(base64.b64decode(t3)))
    assert img.format == "JPEG"
    assert max(img.size) <= 400  # reference thumbnail contract


def test_missing_file_raises(tmp_path):
    import pytest

    with pytest.raises(OSError):
        thumbs.thumbnail_b64(str(tmp_path / "nope.jpg"))
