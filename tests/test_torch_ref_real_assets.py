"""The port against tests/test_real_assets.py: asset-gated fidelity
against REAL released weights and the real vocab.

Its skips are the JAX file's, unchanged. Harness only: the converted
params become a port module (``params_from_numpy`` on the CPU) and the
engine is made on the CPU.

The permanent suite oracles against a random-init HF CLIPModel and a
synthetic merge table (this image ships no CLIP assets — zero egress).
These tests close the remaining gap (VERDICT r2 missing #1): the day real
assets are mounted, one command proves token-ID exactness and embedding
fidelity through the actual `convert -> encode -> search` flow. They SKIP
cleanly when the assets are absent.

Runbook (docs/OPERATIONS.md, "Verifying real assets"):

    EVOSSEARCH_REAL_BPE_VOCAB=/path/bpe_simple_vocab_16e6.txt.gz \
    EVOSSEARCH_REAL_CHECKPOINT=/path/ViT-B-32.pt-or-hf-dir \
    python -m pytest tests/test_real_assets.py -q

Optionally record/verify golden embeddings across environments:
    EVOSSEARCH_WRITE_GOLDEN=goldens.npz  (record on the blessed host)
    EVOSSEARCH_REAL_GOLDEN=goldens.npz   (verify elsewhere)

Reference counterpart: the reference runs real OpenAI checkpoints and the
real merge table directly (oldapp.py:28 `clip.load`, :48 `clip.tokenize`).
"""

import os
from pathlib import Path

import numpy as np
import pytest

VOCAB = os.environ.get("EVOSSEARCH_REAL_BPE_VOCAB", "")
CKPT = os.environ.get("EVOSSEARCH_REAL_CHECKPOINT", "")

needs_vocab = pytest.mark.skipif(
    not (VOCAB and Path(VOCAB).exists()),
    reason="EVOSSEARCH_REAL_BPE_VOCAB not set / not found (real-asset test)",
)
needs_ckpt = pytest.mark.skipif(
    not (CKPT and Path(CKPT).exists()),
    reason="EVOSSEARCH_REAL_CHECKPOINT not set / not found (real-asset test)",
)

# Golden token IDs produced by the reference `clip.tokenize` with the
# released bpe_simple_vocab_16e6.txt.gz (SOT=49406, EOT=49407).
GOLDEN_TOKENS = {
    "a photo of a cat": [49406, 320, 1125, 539, 320, 2368, 49407],
    "a photo of a dog": [49406, 320, 1125, 539, 320, 1929, 49407],
}


def _fixture_image(size: int) -> np.ndarray:
    """Deterministic RGB gradient — the fixed input behind the goldens."""
    y, x = np.mgrid[0:size, 0:size]
    r = (x * 255 // max(size - 1, 1)).astype(np.uint8)
    g = (y * 255 // max(size - 1, 1)).astype(np.uint8)
    b = ((x + y) * 255 // max(2 * (size - 1), 1)).astype(np.uint8)
    return np.stack([r, g, b], axis=-1)


@needs_vocab
def test_real_vocab_token_ids_exact():
    from evossearch_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer(VOCAB)
    assert not tok.fallback, "real vocab configured but fallback engaged"
    for text, golden in GOLDEN_TOKENS.items():
        ids = np.asarray(tok.tokenize([text], 77))[0]
        np.testing.assert_array_equal(
            ids[: len(golden)], golden, err_msg=f"token mismatch for {text!r}"
        )
        assert (ids[len(golden):] == 0).all(), "padding must be zeros"


def _load_real_params():
    if CKPT.endswith(".npz"):
        from evossearch_tpu_torch.models.checkpoint import load_params

        return load_params(CKPT)
    from evossearch_tpu_torch.models.convert import load_checkpoint

    return load_checkpoint(CKPT)


@needs_ckpt
def test_real_checkpoint_embeddings():
    """Converted real weights produce unit-norm, finite embeddings; when a
    golden file or an HF torch oracle is available, cosine > 0.999."""
    import torch

    from evossearch_tpu_torch.models import (
        encode_image, encode_text, params_from_numpy,
    )
    from evossearch_tpu_torch.preprocess.pipeline import preprocess_reference
    from PIL import Image

    params, spec = _load_real_params()
    params = params_from_numpy(params, spec, "cpu")
    img = _fixture_image(2 * spec.image_size)
    x = preprocess_reference(Image.fromarray(img), spec.image_size)

    if VOCAB and Path(VOCAB).exists():
        from evossearch_tpu_torch.tokenizer import load_tokenizer

        tokens = np.asarray(load_tokenizer(VOCAB).tokenize(
            list(GOLDEN_TOKENS), spec.context_length
        ), np.int32)
    else:
        tokens = np.zeros((2, spec.context_length), np.int32)
        tokens[:, 0] = spec.vocab_size - 2
        tokens[:, 1] = spec.vocab_size - 1

    img_emb = encode_image(params, torch.as_tensor(np.asarray(x)[None])).numpy()
    txt_emb = encode_text(params, torch.from_numpy(tokens)).numpy()
    for emb in (img_emb, txt_emb):
        assert np.isfinite(emb).all()
        np.testing.assert_allclose(
            np.linalg.norm(emb, axis=-1), 1.0, atol=1e-4
        )

    write = os.environ.get("EVOSSEARCH_WRITE_GOLDEN")
    if write:
        np.savez(write, image_emb=img_emb, text_emb=txt_emb, model=spec.name)

    golden_path = os.environ.get("EVOSSEARCH_REAL_GOLDEN", "")
    if golden_path and Path(golden_path).exists():
        g = np.load(golden_path)
        assert (img_emb * g["image_emb"]).sum(-1).min() > 0.999
        assert (txt_emb * g["text_emb"]).sum(-1).min() > 0.999

    if Path(CKPT).is_dir():  # HF dir: torch oracle on the same inputs
        transformers = pytest.importorskip("transformers")
        model = transformers.CLIPModel.from_pretrained(CKPT).eval()
        with torch.no_grad():
            t_img = model.get_image_features(
                pixel_values=torch.from_numpy(
                    x[None].transpose(0, 3, 1, 2).copy()
                )
            ).numpy()
            t_txt = model.get_text_features(
                input_ids=torch.from_numpy(tokens.astype(np.int64))
            ).numpy()
        t_img /= np.linalg.norm(t_img, axis=-1, keepdims=True)
        t_txt /= np.linalg.norm(t_txt, axis=-1, keepdims=True)
        assert (img_emb * t_img).sum(-1).min() > 0.999
        assert (txt_emb * t_txt).sum(-1).min() > 0.999


@needs_ckpt
@needs_vocab
def test_real_assets_end_to_end_search(tmp_path, monkeypatch):
    """The full flow the reference runs: real weights + real vocab through
    convert -> index -> text search, self-retrieval sanity included."""
    from PIL import Image

    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine

    folder = tmp_path / "imgs"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        arr = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
        Image.fromarray(arr).save(folder / f"i{i}.jpg", quality=90)
    monkeypatch.setenv("EVOSSEARCH_CHECKPOINT", CKPT)
    monkeypatch.setenv("EVOSSEARCH_BPE_VOCAB", VOCAB)
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "0")
    eng = SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), device="cpu")
    assert eng.index_folder(str(folder)) == 3
    s, i, reader = eng.search_text(str(folder), "a photo of a cat", 3)
    assert len(s) == 3 and (np.diff(s) <= 1e-6).all()
    # image self-retrieval: querying with an indexed image returns itself
    target = Image.open(reader.paths[1])
    s2, i2, _ = eng.search_image(str(folder), target, 3)
    assert int(i2[0]) == 1 and s2[0] > 0.98
