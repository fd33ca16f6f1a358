"""The port's core tables and config against the JAX package's."""

import dataclasses
import os

import pytest

from evossearch_tpu.core import Config as RefConfig
from evossearch_tpu.core import constants as ref_constants
from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core import constants


def test_model_specs_equal():
    assert set(constants.CLIP_MODEL_SPECS) == set(ref_constants.CLIP_MODEL_SPECS)
    for name, spec in constants.CLIP_MODEL_SPECS.items():
        ref = ref_constants.CLIP_MODEL_SPECS[name]
        assert type(spec).__name__ == type(ref).__name__
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref)
        assert spec.family == ref.family


def test_image_constants_equal():
    for name in ("CLIP_IMAGE_MEAN", "CLIP_IMAGE_STD", "CLIP_CONTEXT_LENGTH",
                 "CLIP_VOCAB_SIZE", "CLIP_SOT_TOKEN", "CLIP_EOT_TOKEN"):
        assert getattr(constants, name) == getattr(ref_constants, name)


ENVS = [
    {},
    {"EVOSSEARCH_PORT": "8123", "EVOSSEARCH_DEBUG": "yes",
     "EVOSSEARCH_CLIP_MODEL": "ViT-L/14"},
    {"EVOSSEARCH_COMPUTE_DTYPE": "float32", "EVOSSEARCH_STORE_DTYPE": "float32",
     "EVOSSEARCH_HBM_BUDGET_MB": "-1", "EVOSSEARCH_MICROBATCH_MS": "0"},
    {"EVOSSEARCH_SEARCH_KERNEL": "pallas", "EVOSSEARCH_SQ8": "off",
     "EVOSSEARCH_SHARD_SIZE": "4096", "EVOSSEARCH_BATCH_SIZE": "7"},
    {"EVOSSEARCH_DEBUG": "0", "EVOSSEARCH_MIN_RESULTS": "2",
     "EVOSSEARCH_MAX_RESULTS": "40", "EVOSSEARCH_DEFAULT_RESULTS": "10"},
]


@pytest.mark.parametrize("env", ENVS)
def test_config_parses_identically(env, monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith("EVOSSEARCH_"):
            monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port = Config(env_path=tmp_path / "missing.env")
    ref = RefConfig(env_path=tmp_path / "missing.env")
    assert vars(port) == vars(ref)


def test_env_file_roundtrip_matches(monkeypatch, tmp_path):
    from evossearch_tpu.core import write_env_file as ref_write
    from evossearch_tpu_torch.core import load_env_file, write_env_file

    settings = {"host": "127.0.0.1", "port": 7001, "debug": True,
                "clipModel": "ViT-B/16", "minResults": 2, "maxResults": 40,
                "defaultResults": 10}
    write_env_file(settings, tmp_path / "a.env")
    ref_write(settings, tmp_path / "b.env")
    assert (tmp_path / "a.env").read_text() == (tmp_path / "b.env").read_text()
    assert load_env_file(tmp_path / "a.env")["EVOSSEARCH_PORT"] == "7001"


def test_capture_trace_writes_a_trace_only_when_configured(tmp_path, monkeypatch):
    import torch

    from evossearch_tpu_torch.utils import StageTimer
    from evossearch_tpu_torch.utils.profiling import capture_trace

    monkeypatch.delenv("EVOSSEARCH_PROFILE_DIR", raising=False)
    with capture_trace():
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())
    monkeypatch.setenv("EVOSSEARCH_PROFILE_DIR", str(tmp_path / "traces"))
    timer = StageTimer()
    with capture_trace():
        with timer.stage("search"):
            torch.ones(4).sum()
    (trace,) = (tmp_path / "traces").iterdir()
    assert trace.suffix == ".json" and "search" in trace.read_text()
