"""The port's native extension against the JAX package's: the port builds
its own copy of the C++ source into ``evossearch_tpu_torch/_build/`` and
loads it as ``evossearch_tpu_torch._native``. Its JPEG decoders return
bytes equal to the JAX package's extension on the same files (same
libjpeg), its host scan results equal to the JAX package's
``exact_search_host`` (ties included), and a JPEG the native decoder
rejects falls back to Pillow, counted."""

import io
import sys
import threading
from collections import Counter
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
from PIL import Image

from evossearch_tpu.index.search import exact_search_host as ref_search_host
from evossearch_tpu.index.search import exact_search_host_reader as ref_search_reader
from evossearch_tpu.index.store import IndexWriter as RefWriter
from evossearch_tpu.preprocess.io import get_native as ref_get_native
from evossearch_tpu_torch import native as native_build
from evossearch_tpu_torch.index.search import exact_search_host, exact_search_host_reader
from evossearch_tpu_torch.index.store import IndexReader, bf16_bits
from evossearch_tpu_torch.preprocess import io as port_io

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def natives():
    port, ref = port_io.get_native(), ref_get_native()
    if port is None or ref is None or not port_io.has_native_decode():
        pytest.skip("no C++ compiler or libjpeg headers here")
    return port, ref


def _smooth(h, w, phase=0.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = (128 + 90 * np.sin(xx / 40 + phase) * np.cos(yy / 30)).clip(0, 255)
    return np.stack([a, 255 - a, np.roll(a, 7, 1)], -1).astype(np.uint8)


def _jpeg(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _jpegs() -> list[bytes]:
    """4:2:0 (odd sizes, large enough to DCT-scale), 4:4:4, progressive,
    grayscale, noise."""
    rng = np.random.default_rng(0)
    return [
        _jpeg(_smooth(480, 640), quality=90),
        _jpeg(_smooth(101, 133, 1.0), quality=85),
        _jpeg(_smooth(1200, 901, 2.0), quality=90),
        _jpeg(_smooth(300, 500, 3.0), quality=95, subsampling=0),
        _jpeg(_smooth(250, 333, 4.0), quality=80, progressive=True),
        _jpeg(_smooth(240, 320)[:, :, 0], quality=90),
        _jpeg(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8), quality=92),
    ]


def test_builds_into_the_ports_build_dir(natives):
    port, ref = natives
    path = Path(port.__file__)
    assert port.__name__ == "evossearch_tpu_torch._native"
    assert path.parent == ROOT / "evossearch_tpu_torch" / "_build"
    assert Path(ref.__file__).parent == ROOT / "evossearch_tpu"
    assert port is not ref


@pytest.mark.parametrize("min_short_side", [0, 224])
@pytest.mark.parametrize("fn", ["decode_jpeg", "decode_jpeg_planar"])
def test_decode_bytes_equal(natives, fn, min_short_side):
    port, ref = natives
    for data in _jpegs():
        got = getattr(port, fn)(data, min_short_side)
        assert got == getattr(ref, fn)(data, min_short_side)
        assert isinstance(got[-1], bytes) and len(got[-1]) > 0


@pytest.mark.parametrize("min_short_side", [0, 224])
@pytest.mark.parametrize("fn", ["decode_jpeg_batch", "decode_jpeg_planar_batch"])
def test_batch_decode_bytes_equal(natives, fn, min_short_side):
    port, ref = natives
    blobs = _jpegs() + [b"not a jpeg"]
    got = getattr(port, fn)(blobs, min_short_side, 3)
    assert got == getattr(ref, fn)(blobs, min_short_side, 3)
    assert got[-1] is None and all(g is not None for g in got[:-1])
    if fn == "decode_jpeg_planar_batch":  # the grayscale file ships RGB
        assert [len(g) for g in got[:-1]] == [7, 7, 7, 7, 7, 3, 7]


def test_loaders_match_the_jax_packages(natives, tmp_path):
    from evossearch_tpu.preprocess import io as ref_io

    paths = []
    for i, data in enumerate(_jpegs()):
        paths.append(tmp_path / f"{i}.jpg")
        paths[-1].write_bytes(data)
    Image.fromarray(_smooth(64, 80)).save(tmp_path / "p.png")
    paths.append(tmp_path / "p.png")
    for name in ("load_batch_planar", "load_batch_rgb"):
        got = getattr(port_io, name)(paths, 224, True)
        want = getattr(ref_io, name)(paths, 224, True)
        for g, w in zip(got, want):
            assert type(g) is type(w)
            for a, b in zip(g if isinstance(g, tuple) else (g,),
                            w if isinstance(w, tuple) else (w,)):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_io.load_image_rgb(paths[2], 224),
                                  ref_io.load_image_rgb(paths[2], 224))


def test_rejected_jpegs_fall_back_to_pillow_counted(natives, tmp_path):
    """A PNG named .jpg: the native decoder rejects it and Pillow decodes
    it; garbage: both reject it. Each route is counted."""
    png_as_jpg = tmp_path / "a.jpg"
    Image.fromarray(_smooth(40, 50)).save(png_as_jpg, format="PNG")
    corrupt = tmp_path / "b.jpg"
    corrupt.write_bytes(b"\xff\xd8 truncated garbage")
    good = tmp_path / "c.jpg"
    good.write_bytes(_jpegs()[0])
    for loader in (port_io.load_batch_planar, port_io.load_batch_rgb):
        counts = Counter()
        out = loader([png_as_jpg, corrupt, good], 224, True, counts)
        np.testing.assert_array_equal(out[0], _smooth(40, 50))
        assert out[1] is None and out[2] is not None
        native = ("decode_native_planar" if loader is port_io.load_batch_planar
                  else "decode_native_rgb")
        assert counts == Counter({"decode_pillow_retry": 2, "decode_pillow": 1,
                                  "decode_failed": 1, native: 1})
    counts = Counter()
    port_io.load_image_rgb(png_as_jpg, 224, True, counts)
    assert counts == Counter({"decode_pillow_retry": 1, "decode_pillow": 1})


def test_fast_off_decodes_with_pillow(natives, tmp_path):
    p = tmp_path / "a.jpg"
    p.write_bytes(_jpegs()[0])
    counts = Counter()
    (arr,) = port_io.load_batch_planar([p], 224, fast=False, counts=counts)
    assert counts == Counter({"decode_pillow": 1}) and arr.shape == (480, 640, 3)


def _corpus(dtype, n=3000, d=32, seed=6):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb[100] = emb[n // 2] = emb[n - 1]  # exact duplicates: score ties
    emb[7] = -emb[n - 1]
    q = emb[n - 1] + 0.01 * rng.standard_normal(d).astype(np.float32)
    if dtype == "bf16":
        return bf16_bits(emb), emb.astype(ml_dtypes.bfloat16), q
    return emb, emb, q


@pytest.mark.parametrize("k", [1, 12, 48])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_host_scan_equals_the_jax_packages(natives, dtype, k):
    port_emb, ref_emb, q = _corpus(dtype)
    s, i = exact_search_host(port_emb, q, k)
    rs, ri = ref_search_host(ref_emb, q, k)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(s, rs)
    assert s.dtype == np.float32 and i.dtype == np.int64
    if k >= 3:
        assert list(i[:3]) == [100, 1500, 2999]  # ties: lowest row first


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_host_scan_numpy_fallback_agrees(natives, monkeypatch, dtype):
    """Without the library the numpy scan returns the same rows (scores to
    summation order)."""
    port_emb, _, q = _corpus(dtype)
    s, i = exact_search_host(port_emb, q, 48)
    monkeypatch.setattr(port_io, "get_native", lambda: None)
    s_np, i_np = exact_search_host(port_emb, q, 48)
    np.testing.assert_array_equal(i, i_np)
    np.testing.assert_allclose(s, s_np, rtol=1e-5)


def test_host_scan_reader_streams_the_mmap(natives, tmp_path):
    """Both packages' readers over one bf16 store of three shards (the
    port reads the JAX package's store files)."""
    port_emb, ref_emb, q = _corpus("bf16", n=2500)
    w = RefWriter.create(tmp_path, model="t", dim=32, dtype_name="bfloat16",
                         rows_per_shard=1000)
    paths = [str(tmp_path / f"{r}.jpg") for r in range(2500)]
    w.append(ref_emb.astype(np.float32), paths,
             [{"path": p, "mtime": 0.0, "size": 0} for p in paths])
    w.finalize()
    reader = IndexReader.open(tmp_path)
    assert all(s.dtype == np.uint16 for s in reader.shard_arrays())
    from evossearch_tpu.index.store import IndexReader as RefReader

    for k in (5, 48):
        s, i = exact_search_host_reader(reader, q, k)
        rs, ri = ref_search_reader(RefReader.open(tmp_path), q, k)
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(s, rs)


def test_build_is_safe_across_concurrent_builders(natives, tmp_path, monkeypatch):
    """Three builders of one source into an empty directory: one compiles
    under the lock, the others wait and load the same library; with
    compiling disallowed an empty directory yields no library."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    # load() registers the module by name; the package's own load stays
    monkeypatch.setitem(sys.modules, native_build.MODULE_NAME,
                        sys.modules[native_build.MODULE_NAME])
    assert native_build.build(compile=False)["library"] is None
    results = [None] * 3

    def run(j):
        results[j] = native_build.build()

    threads = [threading.Thread(target=run, args=(j,)) for j in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads)
    libs = {r["library"] for r in results}
    assert len(libs) == 1 and next(iter(libs)).exists()
    assert sum(r["seconds"] is not None for r in results) == 1
    assert not list(tmp_path.glob("*.tmp"))
    assert native_build.build(compile=False)["library"] in libs
    mod = native_build.load(next(iter(libs)))
    assert hasattr(mod, "topk_bf16") and hasattr(mod, "decode_jpeg_planar_batch")


@pytest.mark.parametrize("why", ["EVOSSEARCH_NO_NATIVE_BUILD", "no compiler"])
def test_no_library_without_a_build(monkeypatch, tmp_path, why):
    """``EVOSSEARCH_NO_NATIVE_BUILD=1`` with no library built, or no g++:
    no extension, and the host scan runs in numpy."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    if why == "no compiler":
        monkeypatch.setattr(native_build, "COMPILER", str(tmp_path / "no-g++"))
    else:
        monkeypatch.setenv("EVOSSEARCH_NO_NATIVE_BUILD", "1")
    port_io.get_native.cache_clear()
    try:
        assert port_io.get_native() is None and not port_io.has_native_decode()
        assert not list(tmp_path.iterdir())
        emb, _, q = _corpus("f32", n=500)
        s, i = exact_search_host(emb, q, 5)
        assert list(i[:3]) == [100, 250, 499]
    finally:
        port_io.get_native.cache_clear()  # the next caller loads the real build
