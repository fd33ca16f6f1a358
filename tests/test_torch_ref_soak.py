"""The port against tests/test_soak.py: concurrency soak: sustained
mixed traffic (searches, image searches, comments, commented-lists,
check-index, stats, and full re-indexes) against one shared engine must
produce zero non-200 responses. A 60s 8-thread run measured 46k requests
with zero errors (round 2); this slow-marked test runs a compact version
so concurrency regressions in the per-folder locks, atomic publish,
comment lock, or micro-batcher are caught automatically.

Harness only: the engine is made on the CPU. The JAX file's ``slow`` mark is kept.
"""

import random
import threading
import time

import numpy as np
import pytest
from PIL import Image

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.server import TestClient, create_app

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)


@pytest.mark.slow
def test_mixed_traffic_soak(tmp_path, monkeypatch):
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    rng = np.random.default_rng(0)
    folders = []
    for f in range(2):
        d = tmp_path / f"f{f}"
        d.mkdir()
        for i in range(5):
            Image.fromarray(
                rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
            ).save(d / f"i{i}.jpg")
        folders.append(str(d))

    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    client = TestClient(create_app(engine=eng, cfg=eng.cfg))
    for d in folders:
        assert client.post("/index", json_body={"folder": d}).status_code == 200

    errors: list = []
    stop = time.time() + 10  # compact: 10s

    def worker(seed):
        lrng = random.Random(seed)
        while time.time() < stop:
            d = lrng.choice(folders)
            op = lrng.random()
            try:
                if op < 0.45:
                    r = client.post("/search", json_body={
                        "folder": d, "query": lrng.choice(["cat", "sky"]),
                        "limit": lrng.choice([3, 12]),
                    })
                elif op < 0.6:
                    r = client.post("/search_by_image", data={
                        "folder": d,
                        "image_path": f"{d}/i{lrng.randrange(5)}.jpg",
                        "limit": "4",
                    })
                elif op < 0.75:
                    r = client.post("/comments", json_body={
                        "folder": d, "image_path": f"{d}/i0.jpg",
                        "comment": f"c{lrng.randrange(100)}",
                    })
                elif op < 0.85:
                    r = client.post("/commented_images", json_body={"folder": d})
                elif op < 0.95:
                    r = client.post("/check_index", json_body={"folder": d})
                else:
                    r = client.post("/index", json_body={"folder": d})
                if r.status_code != 200:
                    errors.append((r.status_code, r.data[:200]))
            except Exception as e:  # pragma: no cover - failure evidence
                errors.append(("exc", repr(e)))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert not errors, errors[:10]
