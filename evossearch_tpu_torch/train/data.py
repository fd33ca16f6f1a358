"""Image-text pair dataset for contrastive training — the PyTorch port's
copy of ``evossearch_tpu/train/data.py`` (host-only: numpy batches).

Layout: a folder of images plus ``captions.json`` mapping filename ->
caption string. Batches are produced with the same preprocess used for
indexing (``prepare_batch``; the device half runs in the training loop)
and the CLIP tokenizer, shuffled per epoch with a seeded RNG: host decode
in a producer thread, static-shape batches, ragged tail dropped
(contrastive loss needs full batches of negatives anyway).
"""

from __future__ import annotations

import json
import queue
import threading
from pathlib import Path

import numpy as np

from ..core.constants import CLIPModelSpec
from ..preprocess.io import load_batch_rgb
from ..preprocess.pipeline import (
    DEFAULT_MAX_SIDE,
    _host_shrink,
    host_apply_resample,
    prepare_batch,
)
from ..preprocess.resize import clip_resize_crop_matrices
from ..tokenizer import CLIPTokenizer


class PairDataset:
    def __init__(
        self,
        folder: str | Path,
        tokenizer: CLIPTokenizer,
        spec: CLIPModelSpec,
        batch_size: int = 32,
        seed: int = 0,
    ):
        self.folder = Path(folder)
        captions = json.loads((self.folder / "captions.json").read_text())
        self.items = [
            (self.folder / name, caption)
            for name, caption in sorted(captions.items())
            if (self.folder / name).exists()
        ]
        if not self.items:
            raise ValueError(f"no captioned images found in {folder}")
        self.tokenizer = tokenizer
        self.spec = spec
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.items) // self.batch_size

    def _canonical(self, arr: np.ndarray) -> np.ndarray:
        """Host resample+crop to (target, target), the device stage's math
        (two resample products with inter-pass round/clamp), so every
        batch holds ONE image size: static shapes for the step, and one
        matrix pair per batch for prepare_batch. Oversized photos
        pre-shrink like the serving path first."""
        t = self.spec.image_size
        if arr.shape[0] > DEFAULT_MAX_SIDE or arr.shape[1] > DEFAULT_MAX_SIDE:
            arr = _host_shrink(arr, DEFAULT_MAX_SIDE, t)
        h, w = arr.shape[:2]
        if (h, w) == (t, t):
            return arr
        mh, mw = clip_resize_crop_matrices(h, w, t)
        return host_apply_resample(arr, mh, mw)

    def epoch(self):
        """Yields (canvases, a_h_u, a_w_u, size_idx, tokens) batches of
        EXACTLY batch_size rows (failed decodes are skipped and the batch
        topped up from later items; the ragged tail is dropped).

        Decode + canonicalize run in a PRODUCER thread, bounded two
        batches ahead, so the device's step overlaps the next batch's
        host decode. JPEGs decode DCT-scaled to the model's input size
        like the indexing path. If the consumer abandons the generator
        mid-epoch the daemon producer parks on the bounded queue until
        process exit (the training loop always drains its epochs)."""
        q: queue.Queue = queue.Queue(maxsize=2)
        end = object()

        def produce():
            try:
                order = self.rng.permutation(len(self.items))
                pending: list[tuple[np.ndarray, str]] = []
                yielded = 0
                for start in range(0, len(order), self.batch_size):
                    chunk = [self.items[i]
                             for i in order[start : start + self.batch_size]]
                    arrays = load_batch_rgb(
                        [p for p, _ in chunk], min_short_side=self.spec.image_size,
                    )
                    for a, (_, cap) in zip(arrays, chunk):
                        if a is None:
                            continue
                        pending.append((self._canonical(a), cap))
                        if len(pending) == self.batch_size:
                            q.put(self._finalize(pending))
                            yielded += 1
                            pending = []
                # the ragged tail is dropped, unless NO full batch came out
                # of the whole epoch (tiny folder, or decode failures ate
                # the margin): one smaller batch beats zero steps
                if pending and yielded == 0 and len(pending) >= 2:
                    q.put(self._finalize(pending))
            except BaseException as e:  # raised again in the consumer
                q.put(e)
                return
            q.put(end)

        threading.Thread(target=produce, name="pair-loader", daemon=True).start()
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def _finalize(self, pending):
        canv, a_h, a_w, idx = prepare_batch(
            [a for a, _ in pending], target=self.spec.image_size
        )
        tokens = self.tokenizer.tokenize(
            [cap for _, cap in pending], self.spec.context_length, truncate=True
        )
        return canv, a_h, a_w, idx, tokens
