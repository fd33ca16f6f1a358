"""The port against tests/test_cli_and_frontend.py: CLI subcommands and
frontend template sanity.

Harness only: the CLI runs with ``--device cpu``, its engine stubs take
the port's ``device`` keyword, and the HF-convert case builds a port
module from the converted npz (``params_from_numpy``) and holds its
embeddings against the JAX package's tower on the same npz.
"""

import json

import numpy as np
import pytest
from PIL import Image

from evossearch_tpu_torch.core.constants import CLIPModelSpec

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)


@pytest.fixture()
def folder(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(
            rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
        ).save(tmp_path / f"x{i}.jpg")
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    return tmp_path


def test_cli_index_and_search(folder, capsys, monkeypatch):
    import evossearch_tpu_torch.__main__ as cli

    # patch the engine to the tiny spec for speed
    from evossearch_tpu_torch.engine import SearchEngine as RealEngine

    monkeypatch.setattr(
        cli, "SearchEngine", None, raising=False
    )  # not used; cli imports inside main

    import evossearch_tpu_torch.engine as engine_mod

    orig_init = RealEngine.__init__

    def tiny_init(self, cfg=None, spec=None, params=None, device=None):
        orig_init(self, cfg=cfg, spec=TINY, params=params, device=device)

    monkeypatch.setattr(engine_mod.SearchEngine, "__init__", tiny_init)

    assert cli.main(["index", str(folder), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip()
    assert json.loads(out) == {"success": True, "count": 4}

    assert cli.main(["search", str(folder), "a photo", "-k", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    row = json.loads(lines[0])
    assert "path" in row and "similarity" in row

    img = str(sorted(folder.glob("*.jpg"))[1])
    assert cli.main(["similar", str(folder), img, "-k", "3", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["path"] == img  # self-hit first


def test_cli_unindexed_folder_errors(tmp_path, capsys, monkeypatch):
    import evossearch_tpu_torch.__main__ as cli
    import evossearch_tpu_torch.engine as engine_mod

    orig_init = engine_mod.SearchEngine.__init__

    def tiny_init(self, cfg=None, spec=None, params=None, device=None):
        orig_init(self, cfg=cfg, spec=TINY, params=params, device=device)

    monkeypatch.setattr(engine_mod.SearchEngine, "__init__", tiny_init)
    assert cli.main(["search", str(tmp_path), "q", "--device", "cpu"]) == 1
    assert cli.main(["index", str(tmp_path), "--device", "cpu"]) == 1


def test_frontend_references_only_real_endpoints():
    """Every fetch() target in the SPA must be a served route."""
    import re

    from evossearch_tpu_torch.server.frontend import PAGE, render_page

    endpoints = set(re.findall(r'fetch\("(/[a-z_]*)', PAGE))
    served = {"/check_index", "/index", "/search", "/search_by_image",
              "/comments", "/commented_images", "/settings", "/image"}
    assert endpoints <= served, endpoints - served
    html = render_page("<option>12</option>", "123")
    assert "{result_options_html}" not in html
    assert "{timestamp}" not in html
    assert html.count("<script>") == html.count("</script>") == 1


def test_cli_convert_hf_checkpoint(tmp_path, capsys):
    """`python -m evossearch_tpu_torch convert <hf_dir> out.npz` -> loadable
    native checkpoint (the offline counterpart of the reference's
    clip.load at oldapp.py:28)."""
    import torch
    from transformers import CLIPConfig, CLIPModel

    import evossearch_tpu_torch.__main__ as cli
    from evossearch_tpu_torch.models import encode_image, params_from_numpy
    from evossearch_tpu_torch.models.checkpoint import load_params

    cfg = CLIPConfig(
        projection_dim=32,
        vision_config=dict(
            image_size=32, patch_size=16, hidden_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256, hidden_act="quick_gelu",
        ),
        text_config=dict(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            hidden_act="quick_gelu", max_position_embeddings=16,
            eos_token_id=255,
        ),
    )
    torch.manual_seed(0)
    src = tmp_path / "hf"
    CLIPModel(cfg).eval().save_pretrained(str(src), safe_serialization=False)
    out = tmp_path / "conv.npz"
    assert cli.main(["convert", str(src), str(out)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["success"] is True and report["params"] > 0

    params, spec = load_params(out)
    assert spec.embed_dim == 32 and spec.vision_layers == 2
    model = params_from_numpy(params, spec, "cpu")
    emb = encode_image(model, torch.zeros((2, 32, 32, 3))).numpy()
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)

    # the JAX package's tower on the converted npz is the oracle
    from evossearch_tpu.models import encode_image as ref_encode_image
    from evossearch_tpu.models.checkpoint import load_params as ref_load_params

    ref_params, ref_spec = ref_load_params(out)
    want = np.asarray(ref_encode_image(
        ref_params, np.zeros((2, 32, 32, 3), np.float32), ref_spec))
    np.testing.assert_allclose(emb, want, rtol=0, atol=1e-5)


def test_cli_train_on_pair_folder(tmp_path, capsys, monkeypatch):
    """`python -m evossearch_tpu_torch train <folder>` fine-tunes on an
    images+captions.json folder and writes a loadable checkpoint."""
    from evossearch_tpu_torch.core import CLIP_MODEL_SPECS
    from evossearch_tpu_torch.models.checkpoint import load_params

    import evossearch_tpu_torch.__main__ as cli

    rng = np.random.default_rng(0)
    captions = {}
    for i in range(8):
        fname = f"img_{i:03d}.jpg"
        arr = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / fname, quality=92)
        captions[fname] = f"photo number {i}"
    (tmp_path / "captions.json").write_text(json.dumps(captions))

    monkeypatch.setitem(CLIP_MODEL_SPECS, "tiny-train", TINY)
    out = tmp_path / "ckpts"
    rc = cli.main([
        "train", str(tmp_path), "--model", "tiny-train",
        "--batch-size", "4", "--epochs", "1", "--out", str(out),
        "--device", "cpu",
    ])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["success"] is True and len(report["loss_history"]) == 1
    params, spec = load_params(out / "clip.npz")
    assert spec.embed_dim == TINY.embed_dim


def test_watch_folder_reindexes_on_change(folder, monkeypatch):
    """watch mode re-indexes when files change and is quiet when nothing
    changed."""
    import evossearch_tpu_torch.__main__ as cli
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine

    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    assert eng.index_folder(str(folder)) == 4

    # no change -> no re-index
    runs = cli.watch_folder(eng, str(folder), interval_s=0.01, max_cycles=2)
    assert runs == 0

    # add a file -> exactly one incremental re-index
    rng = np.random.default_rng(1)
    Image.fromarray(
        rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    ).save(folder / "new.jpg")
    runs = cli.watch_folder(eng, str(folder), interval_s=0.01, max_cycles=3)
    assert runs == 1
    _, reader = eng._cached_index(str(folder))
    assert reader.count == 5


def test_watch_folder_quiet_with_undecodable_file(folder, monkeypatch):
    """Regression: an undecodable image is in the folder forever but
    never in the index — the watcher must not re-index every cycle."""
    import evossearch_tpu_torch.__main__ as cli
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine

    (folder / "broken.jpg").write_bytes(b"not a jpeg")
    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    assert eng.index_folder(str(folder)) == 4  # corrupt one skipped
    runs = cli.watch_folder(eng, str(folder), interval_s=0.01, max_cycles=4)
    assert runs <= 1  # one catch-up run at most, then quiet
    runs = cli.watch_folder(eng, str(folder), interval_s=0.01, max_cycles=3)
    assert runs <= 1
