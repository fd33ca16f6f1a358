"""The port against tests/test_home_options.py: gET / result-limit
option generation, small-range branch (oldapp.py:208-217: max<=20 adds
every value divisible by 2 or 3).

Nothing to adapt: the package is renamed.
"""

import re

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.server.app import _result_options_html


def _options(monkeypatch, mn, df, mx):
    monkeypatch.setenv("EVOSSEARCH_MIN_RESULTS", str(mn))
    monkeypatch.setenv("EVOSSEARCH_DEFAULT_RESULTS", str(df))
    monkeypatch.setenv("EVOSSEARCH_MAX_RESULTS", str(mx))
    cfg = Config(env_path=None)
    html = _result_options_html(cfg)
    values = [int(v) for v in re.findall(r'value="(\d+)"', html)]
    selected = [int(v) for v in re.findall(r'value="(\d+)" selected', html)]
    return values, selected


def test_small_range(monkeypatch):
    values, selected = _options(monkeypatch, 3, 8, 20)
    # min/default/max plus i in [3..20] where i%2==0 or i%3==0
    expected = sorted({3, 8, 20} | {i for i in range(3, 21) if i % 2 == 0 or i % 3 == 0})
    assert values == expected
    assert selected == [8]


def test_large_range(monkeypatch):
    values, selected = _options(monkeypatch, 3, 12, 48)
    assert values == [3, 6, 12, 18, 24, 30, 48]
    assert selected == [12]


def test_degenerate_range(monkeypatch):
    values, _ = _options(monkeypatch, 5, 5, 5)
    assert values == [5]
