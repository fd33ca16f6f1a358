"""The planar 4:2:0 JPEG path of the port against the JAX package's:
``prepare_batch_planar`` and ``planar_to_rgb_host`` are equal array for
array; ``device_preprocess_planar_indexed`` agrees within 1e-4 in
normalized units, except where the two packages' float32 summation orders
land on opposite sides of a round-half case (1 LSB of a plane, at most 2
LSB of a channel after the color transform, on at most 0.1% of values:
the rule of ``tests/test_torch_preprocess.py``). ``index_folder`` with the
default flags decodes JPEGs natively to planes, and agrees with the JAX
engine on the same folder and npz weights (f32 compute and store) within
EMB_ATOL; the planar and RGB routes agree to cosine > 0.999."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from evossearch_tpu.core import Config as RefConfig
from evossearch_tpu.engine import SearchEngine as RefEngine
from evossearch_tpu.index import IndexReader as RefReader
from evossearch_tpu.models import init_params
from evossearch_tpu.models.checkpoint import save_params
from evossearch_tpu.preprocess import device_preprocess_planar_indexed as ref_device
from evossearch_tpu.preprocess import planar_to_rgb_host as ref_to_rgb
from evossearch_tpu.preprocess import prepare_batch_planar as ref_prepare
from evossearch_tpu.preprocess.io import get_native as ref_get_native
from evossearch_tpu_torch.core import CLIPModelSpec, Config
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.index import IndexReader
from evossearch_tpu_torch.preprocess import (
    device_preprocess_planar_indexed,
    planar_to_rgb_host,
    prepare_batch_planar,
)
from evossearch_tpu_torch.preprocess.io import has_native_decode

EMB_ATOL = 1e-4
STEP = 1.0 / (255 * 0.26130258)  # one 8-bit step in normalized units, at most
TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)
SIZES = [(240, 320), (101, 133), (480, 360), (224, 224), (500, 700), (97, 2000)]


def _planes(seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for h, w in SIZES:
        ch, cw = (h + 1) // 2, (w + 1) // 2
        out.append((rng.integers(0, 256, (h, w), dtype=np.uint8),
                    rng.integers(0, 256, (ch, cw), dtype=np.uint8),
                    rng.integers(0, 256, (ch, cw), dtype=np.uint8)))
    return out


@pytest.mark.parametrize("target", [224, 64])
def test_prepare_batch_planar_equal(target):
    planes = _planes()[:-1]  # the ladder takes sides up to 1024
    got, want = prepare_batch_planar(planes, target), ref_prepare(planes, target)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_prepare_batch_planar_validates_chroma_shape():
    y = np.zeros((100, 120), np.uint8)
    good, bad = np.zeros((50, 60), np.uint8), np.zeros((50, 61), np.uint8)
    with pytest.raises(ValueError):
        prepare_batch_planar([(y, good, bad)])
    out = prepare_batch_planar([(y, good, good)])
    assert out[0].shape == (1, 128, 128) and out[1].shape == (1, 64, 64, 2)


@pytest.mark.parametrize("i", range(len(SIZES)))
def test_planar_to_rgb_host_equal(i):
    planes = _planes(1)[i]
    got = planar_to_rgb_host(*planes)
    np.testing.assert_array_equal(got, ref_to_rgb(*planes))
    assert got.shape == planes[0].shape + (3,) and got.dtype == np.uint8


@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_device_preprocess_planar_matches(out_dtype):
    prepared = prepare_batch_planar(_planes(2)[:-1], 224)
    dt = torch.bfloat16 if out_dtype else None
    got = device_preprocess_planar_indexed(
        *(torch.from_numpy(a) for a in prepared), out_dtype=dt)
    want = np.asarray(ref_device(*(jnp.asarray(a) for a in prepared),
                                 out_dtype=jnp.bfloat16 if out_dtype else None)
                      .astype(jnp.float32))
    assert got.shape == want.shape == (5, 224, 224, 3)
    assert got.dtype == (dt or torch.float32)
    diff = np.abs(got.float().numpy() - want)
    # bf16 output: one bf16 ulp of values below 4 on top
    atol = EMB_ATOL + (2.0 ** -6 if out_dtype else 0.0)
    flips = diff > atol
    assert flips.mean() <= 1e-3
    assert diff.max() <= 2 * STEP + atol


def _smooth(h, w, phase=0.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = (128 + 90 * np.sin(xx / 40 + phase) * np.cos(yy / 30)).clip(0, 255)
    return np.stack([a, 255 - a, np.roll(a, 7, 1)], -1).astype(np.uint8)


def _write_folder(folder) -> None:
    """JPEGs of mixed sizes (one wider than the canvas ladder after its
    DCT-scaled decode, so the builder reroutes it through the host RGB
    conversion), a grayscale JPEG (native RGB) and a PNG (Pillow)."""
    folder.mkdir()
    for i, (h, w) in enumerate([(240, 320), (101, 133), (480, 640), (300, 2400),
                                (64, 64)]):
        Image.fromarray(_smooth(h, w, float(i))).save(folder / f"j{i}.jpg", quality=90)
    Image.fromarray(_smooth(80, 90)[:, :, 0]).save(folder / "g.jpg", quality=90)
    Image.fromarray(_smooth(96, 128)).save(folder / "p.png")


def _engines(tmp, ckpt, **extra):
    saved = dict(os.environ)
    try:
        for key in list(os.environ):
            if key.startswith("EVOSSEARCH_"):
                del os.environ[key]
        os.environ.update({
            "EVOSSEARCH_COMPUTE_DTYPE": "float32",
            "EVOSSEARCH_STORE_DTYPE": "float32",
            "EVOSSEARCH_BATCH_SIZE": "4",
            "EVOSSEARCH_CHECKPOINT": str(ckpt),
            **extra,
        })
        env = tmp / "missing.env"
        cfg, ref_cfg = Config(env_path=env), RefConfig(env_path=env)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return SearchEngine(cfg=cfg, device="cpu"), RefEngine(cfg=ref_cfg)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("planar_ckpt")
    return save_params(root / "tiny.npz", init_params(jax.random.key(5), TINY), TINY)


def _need_decoders():
    ref = ref_get_native()
    if not has_native_decode() or ref is None or not hasattr(ref, "decode_jpeg_planar_batch"):
        pytest.skip("no C++ compiler or libjpeg headers here")


def test_index_folder_default_flags_match_jax(ckpt, tmp_path):
    _need_decoders()
    port, ref = _engines(tmp_path, ckpt)
    try:
        assert port.cfg.FAST_DECODE and port.cfg.PLANAR_JPEG
        for name, eng in (("port", port), ("ref", ref)):
            _write_folder(tmp_path / name)
            assert eng.index_folder(str(tmp_path / name)) == 7
        counts = port.counters.snapshot()
        assert counts.get("decode_native_planar") == 5
        assert counts.get("decode_native_rgb") == 1
        assert counts.get("decode_pillow") == 1
        got, want = IndexReader.open(tmp_path / "port"), RefReader.open(tmp_path / "ref")
        assert [p.rsplit("/", 1)[1] for p in got.paths] == \
               [p.rsplit("/", 1)[1] for p in want.paths]
        np.testing.assert_allclose(np.asarray(got.embeddings(), np.float32),
                                   np.asarray(want.embeddings(), np.float32),
                                   atol=EMB_ATOL)
    finally:
        port.close()


def test_planar_and_rgb_routes_agree(ckpt, tmp_path):
    _need_decoders()
    folder = tmp_path / "photos"
    _write_folder(folder)
    embs = {}
    for planar in ("1", "0"):
        port, _ = _engines(tmp_path, ckpt, EVOSSEARCH_PLANAR_JPEG=planar)
        try:
            assert port.index_folder(str(folder)) == 7
            counts = port.counters.snapshot()
            assert counts.get("decode_native_planar", 0) == (5 if planar == "1" else 0)
        finally:
            port.close()
        reader = IndexReader.open(folder)
        embs[planar] = dict(zip(reader.paths, np.asarray(reader.embeddings(), np.float32)))
        shutil.rmtree(folder / ".clip_index")
    assert embs["1"].keys() == embs["0"].keys()
    for path, e in embs["1"].items():
        cos = float(e @ embs["0"][path])
        assert cos > 0.999, (path, cos)


def _smoke_photos(folder, count):
    """``chip_smoke.write_jpegs``'s seeded photos (mixed sizes, one FHD in
    eight, the last a 400x4000 panorama)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_photos", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    folder.mkdir()
    smoke.write_jpegs(folder, count)


def test_default_decode_cosines_match_jax_on_the_smoke_photos(tmp_path):
    """The defaults (DCT-scaled native planar decode) against Pillow at
    full size (FAST_DECODE=0 PLANAR_JPEG=0), photo by photo, on the
    smoke's first 8 photos (one FHD, decoded at 1/4 scale, and the
    panorama) at the model input of 224 px: the port's cosines are the
    JAX package's, to float32 summation order (5e-6)."""
    _need_decoders()
    spec = CLIPModelSpec(name="t224", image_size=224, patch_size=32, vision_width=64,
                         vision_layers=2, vision_heads=4, text_width=32, text_layers=1,
                         text_heads=2, vocab_size=128, context_length=8, embed_dim=16)
    ckpt = save_params(tmp_path / "t224.npz", init_params(jax.random.key(8), spec), spec)
    folder = tmp_path / "photos"
    _smoke_photos(folder, 8)
    cos = {}
    for route, flags in (("defaults", {}), ("pillow", {"EVOSSEARCH_FAST_DECODE": "0",
                                                       "EVOSSEARCH_PLANAR_JPEG": "0"})):
        port, ref = _engines(tmp_path, ckpt, **flags)
        try:
            for name, eng, reader in (("port", port, IndexReader), ("jax", ref, RefReader)):
                shutil.rmtree(folder / ".clip_index", ignore_errors=True)
                assert eng.index_folder(str(folder)) == 8
                r = reader.open(str(folder))
                emb = np.asarray(r.embeddings(), np.float32)
                cos.setdefault(name, {})[route] = dict(zip(r.paths, emb))
        finally:
            port.close()
    per_photo = {
        name: {p: float(e @ c["pillow"][p] / np.linalg.norm(e) / np.linalg.norm(c["pillow"][p]))
               for p, e in c["defaults"].items()}
        for name, c in cos.items()
    }
    assert per_photo["port"].keys() == per_photo["jax"].keys()
    for p, v in per_photo["port"].items():
        assert abs(v - per_photo["jax"][p]) <= 5e-6, (p, v, per_photo["jax"][p])
    # the FHD photo, at 0.99795 in both packages: the JAX package's own
    # 0.999 (tests/test_native.py, tests/test_planar.py) is set on smooth
    # images, and its decode routes part further on these photos
    worst = min(per_photo["jax"], key=per_photo["jax"].get)
    assert worst.endswith("img_005.jpg") and per_photo["jax"][worst] < 0.999
