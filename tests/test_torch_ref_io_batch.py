"""The port against tests/test_io_batch.py: load_batch_rgb: mixed
formats, corrupt entries, PIL fallback routing.

Nothing to adapt: the package is renamed.
"""

import numpy as np
import pytest
from PIL import Image

from evossearch_tpu_torch.preprocess.io import load_batch_rgb


def test_mixed_batch(tmp_path):
    rng = np.random.default_rng(0)
    jpg = tmp_path / "a.jpg"
    png = tmp_path / "b.png"
    bad = tmp_path / "c.jpg"
    Image.fromarray(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)).save(jpg)
    Image.fromarray(rng.integers(0, 256, (40, 50, 4), dtype=np.uint8), "RGBA").save(png)
    bad.write_bytes(b"not a jpeg at all")
    out = load_batch_rgb([jpg, png, bad], min_short_side=0)
    assert out[0] is not None and out[0].shape == (60, 80, 3)
    assert out[1] is not None and out[1].shape == (40, 50, 3)  # RGBA -> RGB
    assert out[2] is None


def test_missing_file(tmp_path):
    out = load_batch_rgb([tmp_path / "nope.jpg"], min_short_side=0)
    assert out == [None]


def test_batch_matches_single(tmp_path):
    rng = np.random.default_rng(1)
    p = tmp_path / "x.jpg"
    Image.fromarray(rng.integers(0, 256, (100, 120, 3), dtype=np.uint8)).save(
        p, quality=95
    )
    from evossearch_tpu_torch.preprocess.io import load_image_rgb

    single = load_image_rgb(p, min_short_side=0, fast=True)
    batch = load_batch_rgb([p], min_short_side=0)[0]
    np.testing.assert_array_equal(single, batch)
