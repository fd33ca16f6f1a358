"""The port's preprocess against the JAX package's. Resample matrices and
indices are identical. The resampled uint8 values (canvases of oversized
images, which the host pre-shrinks, and the device output before the
mean/std normalize) are bit-equal except where the two packages'
summation orders land on opposite sides of a round-half case: at most
1 LSB, on at most 0.1% of values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.core.constants import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from evossearch_tpu.preprocess import device_preprocess_indexed as ref_device
from evossearch_tpu.preprocess import prepare_batch as ref_prepare
from evossearch_tpu.preprocess.pipeline import host_apply_resample as ref_host
from evossearch_tpu_torch.preprocess import device_preprocess_indexed, prepare_batch
from evossearch_tpu_torch.preprocess.pipeline import host_apply_resample

MEAN = np.asarray(CLIP_IMAGE_MEAN, np.float32) * 255.0
STD = np.asarray(CLIP_IMAGE_STD, np.float32) * 255.0

# case -> (target, max_side, source sizes); "oversized" shrinks the canvas
# ladder so its images take the host pre-shrink at a small size
CASES = {
    "mixed": (224, 1024, [(300, 400), (224, 224), (97, 131), (64, 64), (480, 360)]),
    "panorama": (224, 1024, [(500, 8000), (240, 320)]),
    "oversized": (64, 256, [(300, 400), (600, 120), (100, 100)]),
}


def _assert_lsb_close(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def _uint8_domain(x: np.ndarray) -> np.ndarray:
    """Invert the normalize: the resample's integer outputs."""
    return np.round(x * STD + MEAN)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_preprocess_matches(case):
    target, max_side, sizes = CASES[case]
    rng = np.random.default_rng(len(case))
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    port = prepare_batch(images, target=target, max_side=max_side)
    ref = ref_prepare(images, target=target, max_side=max_side)
    _assert_lsb_close(port[0], ref[0])
    for a, b in zip(port[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    got = device_preprocess_indexed(*(torch.from_numpy(a) for a in port)).numpy()
    want = np.asarray(ref_device(*(jnp.asarray(a) for a in ref)))
    assert got.shape == want.shape == (len(images), target, target, 3)
    _assert_lsb_close(_uint8_domain(got), _uint8_domain(want))


def test_out_dtype_bf16():
    rng = np.random.default_rng(5)
    prepared = prepare_batch(
        [rng.integers(0, 256, (80, 100, 3), dtype=np.uint8)], target=64)
    x = device_preprocess_indexed(
        *(torch.from_numpy(a) for a in prepared), out_dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16 and x.shape == (1, 64, 64, 3)


@pytest.mark.parametrize("hw", [(120, 90), (270, 480)])
def test_host_resample_matches(hw):
    rng = np.random.default_rng(6)
    arr = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    from evossearch_tpu_torch.preprocess import resample_matrix

    a_h = resample_matrix(hw[0], hw[0] // 2)
    a_w = resample_matrix(hw[1], hw[1] // 2)
    _assert_lsb_close(host_apply_resample(arr, a_h, a_w), ref_host(arr, a_h, a_w))
