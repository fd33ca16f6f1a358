"""The port against tests/test_config.py: config system tests: env-var
surface, .env round-trip (reference config.py:18-45 and
oldapp.py:2216-2248 contracts).

Nothing to adapt: the package is renamed.
"""

import os

from evossearch_tpu_torch.core import Config, load_env_file, write_env_file


def test_defaults(monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith("EVOSSEARCH_"):
            monkeypatch.delenv(key)
    cfg = Config(env_path=tmp_path / "missing.env")
    assert cfg.PORT == 5000
    assert cfg.CLIP_MODEL == "ViT-B/32"
    assert cfg.MIN_RESULTS == 3
    assert cfg.MAX_RESULTS == 48
    assert cfg.DEFAULT_RESULTS == 12
    assert cfg.THUMBNAIL_SIZE == (400, 400)
    assert cfg.SUPPORTED_EXTENSIONS == {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
    assert cfg.INDEX_FOLDER_NAME == ".clip_index"


def test_env_overrides(monkeypatch, tmp_path):
    monkeypatch.setenv("EVOSSEARCH_PORT", "8123")
    monkeypatch.setenv("EVOSSEARCH_DEBUG", "yes")
    monkeypatch.setenv("EVOSSEARCH_CLIP_MODEL", "ViT-L/14")
    cfg = Config(env_path=tmp_path / "missing.env")
    assert cfg.PORT == 8123
    assert cfg.DEBUG is True
    assert cfg.CLIP_MODEL == "ViT-L/14"


def test_env_file_roundtrip(monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith("EVOSSEARCH_"):
            monkeypatch.delenv(key)
    env = tmp_path / ".env"
    settings = {
        "host": "127.0.0.1",
        "port": 7001,
        "debug": True,
        "clipModel": "ViT-B/16",
        "minResults": 2,
        "maxResults": 40,
        "defaultResults": 10,
    }
    write_env_file(settings, env)
    loaded = load_env_file(env)
    assert loaded["EVOSSEARCH_PORT"] == "7001"
    assert loaded["EVOSSEARCH_DEBUG"] == "true"
    # defaults for keys not provided are filled in (oldapp.py:2233-2243)
    assert loaded["EVOSSEARCH_BATCH_SIZE"] == "32"
    cfg = Config(env_path=env)
    assert cfg.PORT == 7001
    assert cfg.DEBUG is True
    assert cfg.CLIP_MODEL == "ViT-B/16"


def test_env_file_parser_quirks(tmp_path, monkeypatch):
    monkeypatch.delenv("EVOSSEARCH_QUOTED", raising=False)
    env = tmp_path / ".env"
    env.write_text('# comment\n\nEVOSSEARCH_QUOTED="hello world"\nBROKEN_LINE\n')
    loaded = load_env_file(env)
    assert loaded == {"EVOSSEARCH_QUOTED": "hello world"}
