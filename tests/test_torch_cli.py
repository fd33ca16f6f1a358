"""The port's CLI (``python -m evossearch_tpu_torch``) against the JAX
package's, as ``tests/test_cli_and_frontend.py`` drives it: ``index`` then
``search``/``similar`` print the same JSON lines (same paths, scores
within EMB_ATOL) from one npz checkpoint on two copies of one folder;
unindexed folders fail; ``convert`` of an HF directory writes the same
npz; ``--watch`` re-indexes on change; ``sq8`` prebuilds the sidecar;
``train`` names its ROADMAP item and fails. Every case passes
``--device cpu``."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

import evossearch_tpu.__main__ as ref_cli
import evossearch_tpu_torch.__main__ as cli
from evossearch_tpu.core import config as ref_config
from evossearch_tpu.models import init_params
from evossearch_tpu.models.checkpoint import load_params as ref_load_params
from evossearch_tpu.models.checkpoint import save_params
from evossearch_tpu_torch.core import CLIPModelSpec
from evossearch_tpu_torch.core import config as port_config
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.index import IndexReader
from evossearch_tpu_torch.index.sq8 import SQ8Index
from evossearch_tpu_torch.models.checkpoint import load_params

ROOT = Path(__file__).resolve().parents[1]
EMB_ATOL = 1e-4
TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_ckpt")
    return save_params(root / "tiny.npz", init_params(jax.random.key(7), TINY), TINY)


@pytest.fixture()
def configured(ckpt, monkeypatch):
    """Both packages' process-wide configs on the tiny checkpoint, f32,
    Pillow decode (the decode routes are test_torch_planar.py's)."""
    for cfg in (port_config, ref_config):
        monkeypatch.setattr(cfg, "CHECKPOINT_PATH", str(ckpt))
        monkeypatch.setattr(cfg, "COMPUTE_DTYPE", "float32")
        monkeypatch.setattr(cfg, "STORE_DTYPE", "float32")
        monkeypatch.setattr(cfg, "FAST_DECODE", False)
        monkeypatch.setattr(cfg, "MICROBATCH_MS", 0, raising=False)
    return ckpt


def _folder(path: Path, count: int = 4) -> Path:
    path.mkdir()
    rng = np.random.default_rng(0)
    for i in range(count):
        Image.fromarray(rng.integers(0, 256, (40 + 8 * i, 50, 3), dtype=np.uint8)
                        ).save(path / f"x{i}.jpg")
    return path


def _lines(capsys) -> list[dict]:
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def _same_results(got: list[dict], want: list[dict], port_dir, ref_dir) -> None:
    assert [Path(r["path"]).relative_to(port_dir) for r in got] == \
           [Path(r["path"]).relative_to(ref_dir) for r in want]
    np.testing.assert_allclose([r["similarity"] for r in got],
                               [r["similarity"] for r in want], atol=EMB_ATOL)


def test_index_search_similar_match_jax_cli(configured, tmp_path, capsys):
    port_dir, ref_dir = _folder(tmp_path / "port"), _folder(tmp_path / "ref")
    assert cli.main(["index", str(port_dir), *CPU]) == 0
    assert _lines(capsys) == [{"success": True, "count": 4}]
    assert ref_cli.main(["index", str(ref_dir)]) == 0
    assert _lines(capsys) == [{"success": True, "count": 4}]

    assert cli.main([*CPU, "search", str(port_dir), "a photo", "-k", "3"]) == 0
    got = _lines(capsys)
    assert ref_cli.main(["search", str(ref_dir), "a photo", "-k", "3"]) == 0
    want = _lines(capsys)
    assert len(got) == 3 and set(got[0]) == {"path", "similarity"}
    _same_results(got, want, port_dir, ref_dir)

    assert cli.main(["similar", str(port_dir), str(port_dir / "x1.jpg"), *CPU]) == 0
    got = _lines(capsys)
    assert ref_cli.main(["similar", str(ref_dir), str(ref_dir / "x1.jpg")]) == 0
    want = _lines(capsys)
    assert got[0]["path"] == str(port_dir / "x1.jpg")  # self-hit first
    _same_results(got, want, port_dir, ref_dir)


def test_unindexed_folder_errors(configured, tmp_path, capsys):
    assert cli.main(["search", str(tmp_path), "q", *CPU]) == 1
    assert cli.main(["index", str(tmp_path), *CPU]) == 1
    assert cli.main(["sq8", str(tmp_path)]) == 1
    err = capsys.readouterr().err
    assert "Folder not indexed" in err and "No images found in folder" in err


def test_convert_hf_directory_matches_jax_cli(tmp_path, capsys):
    import torch
    from transformers import CLIPConfig, CLIPModel

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
    assert cli.main(["convert", str(src), str(tmp_path / "port"), *CPU]) == 0
    report = _lines(capsys)[-1]
    assert ref_cli.main(["convert", str(src), str(tmp_path / "ref.npz")]) == 0
    ref_report = _lines(capsys)[-1]
    assert report["out"] == str(tmp_path / "port.npz")  # suffix appended
    assert {k: v for k, v in report.items() if k != "out"} == \
           {k: v for k, v in ref_report.items() if k != "out"}
    assert report["success"] is True and report["params"] > 0
    params, spec = load_params(tmp_path / "port.npz")
    ref_params, ref_spec = ref_load_params(tmp_path / "ref.npz")
    assert spec.embed_dim == 32 and spec.vision_layers == 2
    assert spec.name == ref_spec.name
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_watch_reindexes_on_change(configured, tmp_path):
    folder = _folder(tmp_path / "photos")
    eng = SearchEngine(cfg=port_config, device="cpu")
    try:
        assert eng.index_folder(str(folder)) == 4
        assert cli.watch_folder(eng, str(folder), interval_s=0.01, max_cycles=2) == 0
        Image.fromarray(np.full((40, 50, 3), 9, np.uint8)).save(folder / "new.jpg")
        assert cli.watch_folder(eng, str(folder), interval_s=0.01, max_cycles=3) == 1
        _, reader = eng._cached_index(str(folder))
        assert reader.count == 5
        # an undecodable file is never indexed: one catch-up run per watch
        # at most, then quiet
        (folder / "broken.jpg").write_bytes(b"not a jpeg")
        assert cli.watch_folder(eng, str(folder), interval_s=0.01, max_cycles=4) <= 1
        assert cli.watch_folder(eng, str(folder), interval_s=0.01, max_cycles=3) <= 1
    finally:
        eng.close()


def test_sq8_prebuilds_the_sidecar(configured, tmp_path, capsys):
    folder = _folder(tmp_path / "photos")
    assert cli.main(["index", str(folder), *CPU]) == 0
    capsys.readouterr()
    assert cli.main(["sq8", str(folder)]) == 0
    first = _lines(capsys)[0]
    assert first["success"] is True and first["built"] is True and first["count"] == 4
    assert cli.main(["sq8", str(folder)]) == 0
    assert _lines(capsys) == [{"success": True, "count": 4, "built": False}]
    reader = IndexReader.open(folder)
    assert SQ8Index.sidecar_mtime(reader) is not None
    assert SQ8Index.load(reader, store_mtime=reader.mtime()) is not None


def test_train_is_not_ported(tmp_path, capsys):
    assert cli.main(["train", str(tmp_path), *CPU]) == 1
    assert "ROADMAP A15" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--device", "cpu", "search", "f", "q"], ["search", "f", "q", "--device", "cpu"],
])
def test_device_option_either_side_of_the_command(argv):
    args = cli._parser().parse_args(argv)
    assert args.device == "cpu" and args.command == "search" and args.k == 12


def test_module_entry_point_runs(tmp_path):
    """``python -m evossearch_tpu_torch`` in a subprocess (argument errors
    exit 2, ``train`` exits 1)."""
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    run = [sys.executable, "-m", "evossearch_tpu_torch"]
    assert subprocess.run(run, capture_output=True, env=env, cwd=tmp_path,
                          timeout=120).returncode == 2
    proc = subprocess.run(run + ["train", str(tmp_path)], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 1 and "A15" in proc.stderr


def test_index_of_a_moved_folder_copy(configured, tmp_path, capsys):
    """The store holds absolute paths: an incremental index of a copied
    folder (its copied store names the original's files) embeds the
    copy's files, and search returns them."""
    folder = _folder(tmp_path / "a")
    assert cli.main(["index", str(folder), *CPU]) == 0
    shutil.copytree(folder, tmp_path / "b")
    assert cli.main(["index", str(tmp_path / "b"), "--incremental", *CPU]) == 0
    capsys.readouterr()
    assert cli.main(["search", str(tmp_path / "b"), "x", "-k", "4", *CPU]) == 0
    assert all(r["path"].startswith(str(tmp_path / "b")) for r in _lines(capsys))
