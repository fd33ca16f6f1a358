"""The port against tests/test_model_family.py: model family sanity,
every reference-offered variant (oldapp.py:1089-1091) has the right
architecture — anchored to the OpenAI release param counts.

Harness only: ``init_params`` takes a torch seed and the CPU where the
JAX file takes a PRNG key, and the engine is made on the CPU."""

import numpy as np
import pytest

from evossearch_tpu_torch.core import CLIP_MODEL_SPECS
from evossearch_tpu_torch.models import count_params, expected_param_count, init_params


# Known totals of the OpenAI release checkpoints.
OPENAI_COUNTS = {
    "ViT-B/32": 151_277_313,
    "ViT-B/16": 149_620_737,
    "ViT-L/14": 427_616_513,
    # L/14 tower at 336 px: only the vision positional embedding grows
    # (577 vs 257 tokens -> +320*1024 params).
    "ViT-L/14@336px": 427_944_193,
}


@pytest.mark.parametrize("name", list(OPENAI_COUNTS))
def test_analytic_counts_match_openai_release(name):
    assert expected_param_count(CLIP_MODEL_SPECS[name]) == OPENAI_COUNTS[name]


def test_init_matches_analytic_count():
    spec = CLIP_MODEL_SPECS["ViT-B/32"]
    params = init_params(spec, seed=0, device="cpu")
    assert count_params(params) == expected_param_count(spec)


def test_token_grid_sizes():
    assert CLIP_MODEL_SPECS["ViT-B/32"].num_image_tokens == 50
    assert CLIP_MODEL_SPECS["ViT-B/16"].num_image_tokens == 197
    assert CLIP_MODEL_SPECS["ViT-L/14"].num_image_tokens == 257
    assert CLIP_MODEL_SPECS["ViT-L/14@336px"].num_image_tokens == 577


def test_unknown_model_name_is_a_clear_error(monkeypatch):
    """clip.load names the bad model and the valid set (oldapp.py:28);
    a bare KeyError out of the spec table would not."""
    from evossearch_tpu_torch.core.config import Config
    from evossearch_tpu_torch.engine import SearchEngine

    monkeypatch.setenv("EVOSSEARCH_CLIP_MODEL", "ViT-H/14")
    with pytest.raises(ValueError, match="ViT-H/14.*available"):
        SearchEngine(cfg=Config(), device="cpu")
