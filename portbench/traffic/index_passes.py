"""Traffic kind ``index_passes``: ``POST /index`` of fresh folders, back to
back, through the whole window.

Set-up: the towers' weights from the seed; ``photos`` photo-like JPEGs
written once by parallel processes; ``max_passes`` folders prepared, each
holding ``photos`` hard links to that one set (so every pass decodes the
same bytes, and the folders cost no copies), and a warm-up folder of
``warm_photos`` links indexed twice.

The window: passes started while less than ``seconds`` have passed since
the first started. The end-to-end rate, ``index_card_images_per_s``, is
all images indexed over the seconds in which the card ran an operation
(kernel, copy or memset) while they were indexed, from a trace of the
card's activity alone that spans every pass (untraced runs on the card;
``None`` otherwise). The rate on the host clock, all images over all the
time from the first pass's start to the last one's end, is in ``ctx``
for the per-layer metric ``host_images_per_s.index``: where the host's
decode paces the passes it spreads with the host's load.

The check, after the window, the peak read and the program freed:
``sample_per_pass`` images per pass (of each folder's last pass, when
the window outlasted ``max_passes`` and folders were indexed again),
drawn from the seed, whose stored
rows are read back from the folder's index and held against the
reference: the documented JPEG route (``reference/image.py``) and the
image tower in float32. Compared: ``cos_gap``, the largest 1 - cosine of
a stored row against the reference's embedding of its image, and
``cos_gap_median``, the median over the sample. A pass that did not
return 200 with every image counted, or a sampled image with no row,
fails the check outright.
"""

from __future__ import annotations

import math
import os
import shutil
import time

import numpy as np

from portbench import data, harness
from portbench.harness import Run, log


def _link_folder(src: list[str], dst) -> None:
    dst.mkdir()
    for p in src:
        os.link(p, dst / os.path.basename(p))


def run(run: Run) -> dict:
    import torch

    params, model = run.traffic, run.model
    t = time.monotonic()
    photos, mean_bytes = data.write_photos(run.tmp / "photos", params["photos"], run.seed,
                                           params["photo"], params["writers"],
                                           run.device)
    log(f"{len(photos)} photos, mean {mean_bytes:.0f} bytes, {time.monotonic() - t:.1f} s")
    folders = []
    for i in range(params["max_passes"]):
        folders.append(run.tmp / f"pass_{i:03d}")
        _link_folder(photos, folders[-1])
    warm = run.tmp / "warm"
    _link_folder(photos[: params["warm_photos"]], warm)
    weights = data.make_weights(model, run.seed, run.device)
    engine = harness.build_engine(run, weights)
    del weights
    server = harness.Server(engine, engine.cfg)
    t = time.monotonic()
    for _ in range(2):
        code, body = harness.post(server.port, "/index", {"folder": str(warm)})
        if code != 200 or body.get("count") != params["warm_photos"]:
            raise RuntimeError(f"warm-up /index returned {code} {body}")
    log(f"warm-up {time.monotonic() - t:.1f} s")
    if run.tamper is not None:
        run.tamper(engine)
    card_trace = not run.trace and run.device.startswith("cuda")
    if run.trace or card_trace:
        harness.warm_profiler(host=run.trace)
    harness.settle()

    if run.device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.monotonic() + params["lead_s"]
    spec = {"kind": "index", "port": server.port, "t0": t0, "seconds": run.seconds,
            "folders": [str(f) for f in folders], "timeout_s": params["timeout_s"],
            "index_folder_name": run.config["engine"]["INDEX_FOLDER_NAME"]}
    card_prof = harness.start_card_trace() if card_trace else None
    proc, out_path = harness.start_client(spec, run.tmp)
    wait = t0 - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    before = harness.snapshot(engine)
    traced = None
    if run.trace:
        traced = harness.traced_subwindow(engine, t0, params["trace_offset_s"],
                                          params["trace_s"])
    res = harness.finish_client(proc, out_path, run.seconds + params["timeout_s"] + 60)
    after = harness.snapshot(engine)
    busy = harness.card_busy_s(run, card_prof) if card_prof is not None else None
    card = harness.card() if run.device.startswith("cuda") else {}
    traced = harness.reduce_subwindow(run, traced)
    server.stop()
    engine.close()
    del engine, server
    import gc

    gc.collect()
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()

    passes = res["passes"]
    images = sum(p["count"] for p in passes)
    elapsed = passes[-1]["end"] - passes[0]["start"]
    failed = sum(params["photos"] for p in passes
                 if p["status"] != 200 or p["count"] != params["photos"])
    log(f"{len(passes)} passes, {images} images in {elapsed:.3f} s, "
        + ", ".join(f"{p['end'] - p['start']:.3f}" for p in passes))
    card_rate = None
    if busy is not None:
        if busy <= 0:
            raise RuntimeError("the card's trace over the window holds no device work")
        card_rate = images / busy
        log(f"card busy {busy:.4f} s: {card_rate:.2f} images/s; "
            f"host clock {images / elapsed:.2f} images/s")
    t = time.monotonic()
    compared, problems = check(run, passes, photos)
    log(f"check {time.monotonic() - t:.1f} s")
    for f in folders + [warm]:
        shutil.rmtree(f, ignore_errors=True)
    return {
        "e2e": {"index_card_images_per_s": card_rate},
        "t0": t0,
        "attempted": len(passes) * params["photos"],
        "failed": failed,
        "card": card,
        "compared": compared,
        "problems": problems,
        "ctx": {"kind": "index", "images": images, "elapsed_s": elapsed,
                "window": harness.delta(before, after), "trace": traced, "model": model},
    }


def sampled(run: Run, n_passes: int, photos: list[str]) -> list[list[int]]:
    """Per pass, the photos whose rows the check reads."""
    rng = np.random.default_rng(data.sub_seed(run.seed, "index-sample"))
    k = min(run.traffic["sample_per_pass"], len(photos))
    return [sorted(rng.choice(len(photos), k, replace=False).tolist()) for _ in range(n_passes)]


def stored_rows(folder: str, names: list[str], index_folder_name: str) -> list:
    """The rows the program stored for files ``names`` of ``folder`` (None
    where it stored none), widened to float32."""
    from evossearch_tpu_torch.index.store import IndexReader, as_float32

    reader = IndexReader.open(folder, index_folder_name)
    if reader is None:
        return [None] * len(names)
    emb = as_float32(np.asarray(reader.embeddings()))
    where = {os.path.basename(p): r for r, p in enumerate(reader.paths)}
    return [emb[where[n]] if n in where else None for n in names]


def reference_embeddings(run: Run, paths: list[str], precision: str):
    """The reference's unit rows of the JPEGs at ``paths``."""
    import torch

    from portbench.reference import clip, image

    model = run.model
    w = data.make_weights(model, run.seed, run.device)
    out = []
    for s in range(0, len(paths), 32):
        px = np.stack([image.preprocess(p, model["image_size"]) for p in paths[s : s + 32]])
        out.append(clip.encode_image(w, torch.as_tensor(px, device=run.device), model,
                                     precision).cpu().numpy())
    del w
    return np.concatenate(out)


def check(run: Run, passes: list[dict], photos: list[str]) -> tuple[dict, list[str]]:
    problems = [f"pass {i}: status {p['status']}, {p['count']} images"
                for i, p in enumerate(passes)
                if p["status"] != 200 or p["count"] != len(photos)]
    picks = sampled(run, len(passes), photos)
    got, refs = [], []
    last = {p["folder"]: i for i, p in enumerate(passes)}  # a folder indexed again
    for n, (p, pick) in enumerate(zip(passes, picks)):
        if last[p["folder"]] != n:
            continue
        names = [os.path.basename(photos[i]) for i in pick]
        rows = stored_rows(p["folder"], names, run.config["engine"]["INDEX_FOLDER_NAME"])
        for i, row in zip(pick, rows):
            if row is None:
                problems.append(f"{p['folder']}: no row for {photos[i]}")
                continue
            got.append(row)
            refs.append(photos[i])
    if not got:
        return {"cos_gap": math.inf, "cos_gap_median": math.inf}, problems or ["nothing to check"]
    ref = reference_embeddings(run, refs, "fp32")
    gaps = cosine_gaps(np.stack(got), ref)
    return {"cos_gap": float(gaps.max()), "cos_gap_median": float(np.median(gaps))}, problems


def cosine_gaps(rows: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """1 - cosine of each row against the reference's row, in float64."""
    a, b = rows.astype(np.float64), ref.astype(np.float64)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return 1.0 - cos
