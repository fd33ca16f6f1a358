"""The plain reference on hand-made cases at tiny widths, and beside the
program on the CPU (float32)."""

import numpy as np
import pytest
import torch

from portbench import data
from portbench.reference import clip, image, tokenizer

TINY = dict(name="tiny", image_size=32, patch_size=8, vision_width=16, vision_layers=2,
            vision_heads=2, text_width=16, text_layers=2, text_heads=2, vocab_size=49408,
            context_length=77, embed_dim=8)


def test_tokenizer_hand_made():
    order = tokenizer._byte_order()
    a, d, o, g = (order.index(ord(c)) for c in "adog")
    assert order[:3] == [ord("!"), ord('"'), ord("#")] and len(set(order)) == 256
    assert tokenizer.encode("A  dog") == [256 + a, d, o, 256 + g]
    assert tokenizer.encode("dog's") == [d, o, 256 + g, order.index(ord("'")),
                                         256 + order.index(ord("s"))]
    rows = tokenizer.tokenize(["a dog", "x " * 80], 77)
    assert rows[0, :6].tolist() == [49406, 256 + a, d, o, 256 + g, 49407]
    assert rows[0, 6:].sum() == 0
    assert rows[1, -1] == 49407 and (rows[1] != 0).all()  # cut, ends in EOT
    with pytest.raises(ValueError):
        tokenizer.encode("café")


def test_tokenizer_matches_the_programs_fallback():
    from evossearch_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer(None)
    assert tok.fallback
    texts = ["sunset over the sea", "two dogs on a beach 3", "red car's door, wet!"]
    np.testing.assert_array_equal(tokenizer.tokenize(texts, 77),
                                  np.asarray(tok.tokenize(texts, 77, truncate=True)))


def test_text_tower_without_blocks_by_hand():
    model = dict(TINY, text_layers=0)
    w = data.make_weights(model, 3, "cpu")
    tokens = torch.as_tensor(tokenizer.tokenize(["a dog"], 77))
    x = (w["text.token_embed"][tokens[0]] + w["text.pos_embed"]).double().numpy()
    row = x[5]  # the end-of-text token
    row = (row - row.mean()) / np.sqrt(row.var() + 1e-5)
    row = row * w["text.ln_final.scale"].double().numpy() + w["text.ln_final.bias"].double().numpy()
    e = row @ w["text.proj"].double().numpy()
    got = clip.encode_text(w, tokens, model)[0].double().numpy()
    np.testing.assert_allclose(got, e / np.linalg.norm(e), atol=1e-6)


def test_text_tower_is_causal():
    w = data.make_weights(TINY, 4, "cpu")
    t = torch.as_tensor(tokenizer.tokenize(["a dog"], 77))
    t2 = t.clone()
    t2[0, 10] = 7  # a token past the end-of-text position changes nothing
    t2[0, 10:] = 0
    a, b = clip.encode_text(w, t, TINY), clip.encode_text(w, t2, TINY)
    torch.testing.assert_close(a, b)


@pytest.mark.parametrize("which", ["text", "image"])
def test_towers_match_the_program_in_float32(which):
    from portbench import harness

    w = data.make_weights(TINY, 5, "cpu")
    from evossearch_tpu_torch.models import CLIP, encode_image, encode_text

    module = CLIP(harness.model_spec(TINY))
    module.load_state_dict(w, strict=True)
    if which == "text":
        tokens = torch.as_tensor(tokenizer.tokenize(["a dog", "three red cars"], 77))
        want = encode_text(module, tokens, torch.float32)
        got = clip.encode_text(w, tokens, TINY)
    else:
        px = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
        want = encode_image(module, px, torch.float32)
        got = clip.encode_image(w, px, TINY)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)
    low = clip.encode_text(w, tokens, TINY, "fp8") if which == "text" else clip.encode_image(
        w, px, TINY, "fp8")
    assert 1e-4 < float((1 - (low * got).sum(-1)).max()) < 0.2


def test_image_route_matches_the_programs_planar_route(tmp_path):
    from evossearch_tpu_torch.preprocess import io as pio
    from evossearch_tpu_torch.preprocess.pipeline import (
        device_preprocess_planar_indexed, prepare_batch_planar)

    if not pio.has_native_decode():
        pytest.skip("the program's native JPEG decoder is not built here")
    photo = dict(height=480, width=640, quality=85, amplitudes=[40, 24, 20, 40],
                 cells=[4, 16, 80, 320], noise=12)
    paths, _ = data.write_photos(tmp_path, 3, 9, photo, 1, "cpu")
    planes = pio.load_batch_planar(paths, 224, True)
    parts = prepare_batch_planar(planes, 224)
    got = device_preprocess_planar_indexed(*(torch.as_tensor(a) for a in parts)).numpy()
    want = np.stack([image.preprocess(p, 224) for p in paths])
    # equal up to a rounding step that the summation order flips: a luma
    # or chroma level moves a channel by up to 1.772 levels, which rounds
    # to 2 or 3 (3 levels over CLIP's smallest std, 0.2613 x 255, is 0.045)
    diff = np.abs(got - want)
    assert diff.max() <= 0.046 and (diff > 1e-4).mean() < 0.01


def test_dct_scale_rule():
    assert image.dct_scale(480, 640, 224) == 4
    assert image.dct_scale(3024, 4032, 224) == 1
    assert image.dct_scale(224, 300, 224) == 8
