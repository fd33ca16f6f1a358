"""Inputs made from the run's seed: the towers' weights, the photo-like
JPEGs and the library's rows. Both sides (the program and the reference)
are handed the same; the reference makes them again from the seed after
the window rather than keep a copy on the card.

Top-level imports stay light (numpy): the JPEG encoders run in spawned
worker processes that import this module.
"""

from __future__ import annotations

import hashlib
import io
import os
from pathlib import Path

import numpy as np

def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed, so the
    weights, the rows, the photos and the schedule draw independently."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


# -- weights ----------------------------------------------------------------


FAMILIES = ("vit", "resnet")


def family(model: dict) -> str:
    """The model family of a configuration's ``model`` block: its
    ``family`` key, ``"vit"`` where it has none."""
    name = model.get("family", "vit")
    if name not in FAMILIES:
        raise ValueError(f"unknown model family {name!r}; known: {', '.join(FAMILIES)}")
    return name


def _transformer(out: list, prefix: str, w: int, layers: int) -> None:
    proj_std = (w ** -0.5) * ((2 * max(layers, 1)) ** -0.5)
    for i in range(layers):
        p = f"{prefix}.blocks.{i}."
        out.extend([
            (p + "ln_1.scale", (w,), 1.0, 0.05), (p + "ln_1.bias", (w,), 0.0, 0.02),
            (p + "attn.wqkv", (w, 3 * w), 0.0, w ** -0.5),
            (p + "attn.bqkv", (3 * w,), 0.0, 0.02),
            (p + "attn.wo", (w, w), 0.0, proj_std), (p + "attn.bo", (w,), 0.0, 0.02),
            (p + "ln_2.scale", (w,), 1.0, 0.05), (p + "ln_2.bias", (w,), 0.0, 0.02),
            (p + "mlp.w1", (w, 4 * w), 0.0, (2 * w) ** -0.5),
            (p + "mlp.b1", (4 * w,), 0.0, 0.02),
            (p + "mlp.w2", (4 * w, w), 0.0, proj_std), (p + "mlp.b2", (w,), 0.0, 0.02),
        ])


def _vit_visual(out: list, model: dict) -> None:
    vw, e = model["vision_width"], model["embed_dim"]
    grid = model["image_size"] // model["patch_size"]
    out.extend([
        ("visual.class_embedding", (vw,), 0.0, vw ** -0.5),
        ("visual.pos_embed", (grid * grid + 1, vw), 0.0, vw ** -0.5),
        ("visual.proj", (vw, e), 0.0, vw ** -0.5),
        ("visual.patch_embed.kernel", (model["patch_size"] ** 2 * 3, vw), 0.0, vw ** -0.5),
        ("visual.ln_pre.scale", (vw,), 1.0, 0.05), ("visual.ln_pre.bias", (vw,), 0.0, 0.02),
    ])
    _transformer(out, "visual", vw, model["vision_layers"])
    out.extend([
        ("visual.ln_post.scale", (vw,), 1.0, 0.05), ("visual.ln_post.bias", (vw,), 0.0, 0.02),
    ])


# The mean of each block's last BatchNorm scale is BRANCH_GAIN over the
# square root of its stage's block count, so that every residual branch
# adds a share and a stage's blocks together grow the stream by a bounded
# factor at any depth (through RN50x64's 64 blocks the stream's RMS stays
# within 1.3-1.7x of the stem's output; tests/test_portbench_resnet.py).
# Larger gains make the tower amplify rounding: at 1.0 bf16 reads ten
# times the gap it reads at 0.5.
BRANCH_GAIN = 0.5


def _resnet_visual(out: list, model: dict) -> None:
    w, c, e = model["vision_width"], model["vision_width"] * 32, model["embed_dim"]

    def conv(p: str, k: int, cin: int, cout: int) -> None:
        out.append((p + ".kernel", (k, k, cin, cout), 0.0, (k * k * cin) ** -0.5))

    def bn(p: str, ch: int, scale: float = 1.0) -> None:
        out.extend([(p + ".scale", (ch,), scale, 0.05 * scale), (p + ".bias", (ch,), 0.0, 0.02),
                    (p + ".mean", (ch,), 0.0, 0.02), (p + ".var", (ch,), 1.0, 0.05)])

    for i, (k, cin, cout) in enumerate([(3, 3, w // 2), (3, w // 2, w // 2), (3, w // 2, w)]):
        conv(f"visual.stem.conv{i + 1}", k, cin, cout)
        bn(f"visual.stem.bn{i + 1}", cout)
    cin = w
    for s, blocks in enumerate(model["vision_layers"]):
        planes = w * 2 ** s
        gain = BRANCH_GAIN / blocks ** 0.5
        for b in range(blocks):
            p = f"visual.stage{s + 1}." + ("down" if b == 0 else f"rest.{b - 1}")
            conv(p + ".conv1", 1, cin, planes)
            bn(p + ".bn1", planes)
            conv(p + ".conv2", 3, planes, planes)
            bn(p + ".bn2", planes)
            conv(p + ".conv3", 1, planes, planes * 4)
            bn(p + ".bn3", planes * 4, gain)
            if b == 0:
                conv(p + ".downsample.conv", 1, cin, planes * 4)
                bn(p + ".downsample.bn", planes * 4)
            cin = planes * 4
    tokens = (model["image_size"] // 32) ** 2 + 1
    p = "visual.attnpool."
    out.append((p + "pos_embed", (tokens, c), 0.0, c ** -0.5))
    for name in ("q", "k", "v"):
        out.extend([(p + f"w{name}", (c, c), 0.0, c ** -0.5), (p + f"b{name}", (c,), 0.0, 0.02)])
    out.extend([(p + "wc", (c, e), 0.0, c ** -0.5), (p + "bc", (e,), 0.0, 0.02)])


def weight_layout(model: dict) -> list[tuple[str, tuple, float, float]]:
    """(name, shape, mean, std) of every tensor of the two towers, in one
    fixed order. Names and layouts are those the program's CLIP module
    takes (dense kernels (in, out); the ViT's patch embedding as a
    (patch*patch*3, width) kernel over patches flattened (ph, pw, c); the
    modified ResNet's conv kernels HWIO (kh, kw, in, out)), and the
    reference reads the same names. Standard deviations follow OpenAI's
    CLIP init; biases, LayerNorm and BatchNorm parameters are drawn too
    (std 0.02, scales 1 +- 0.05), so that a fault in their use shows. The
    ResNet's BatchNorm statistics listed here (0 +- 0.02, 1 +- 0.05) are
    replaced by ``make_weights``. OpenAI zeroes each Bottleneck's last
    BatchNorm scale, which would leave every residual branch out of the
    output: here it is drawn with the mean ``BRANCH_GAIN / sqrt(blocks in
    the stage)``."""
    out: list[tuple[str, tuple, float, float]] = [("logit_scale", (), 2.6592600, 0.0)]
    (_resnet_visual if family(model) == "resnet" else _vit_visual)(out, model)
    tw, e = model["text_width"], model["embed_dim"]
    out.extend([
        ("text.token_embed", (model["vocab_size"], tw), 0.0, 0.02),
        ("text.pos_embed", (model["context_length"], tw), 0.0, 0.01),
        ("text.proj", (tw, e), 0.0, tw ** -0.5),
    ])
    _transformer(out, "text", tw, model["text_layers"])
    out.extend([
        ("text.ln_final.scale", (tw,), 1.0, 0.05), ("text.ln_final.bias", (tw,), 0.0, 0.02),
    ])
    return out


def make_weights(model: dict, seed: int, device) -> dict:
    """Every tensor of ``weight_layout`` in float32 on ``device``: views of
    one seeded normal draw made on the device in a single call, scaled in
    place. A ResNet's BatchNorm statistics are then set from a seeded
    batch of photo-like images (``reference.resnet.calibrate_batchnorm``),
    as a released model's are those of its training data. A run makes the
    weights again for its check: the statistics may then differ in their
    last bits (the convs' summation order), far below any gap compared."""
    import torch

    layout = weight_layout(model)
    total = sum(int(np.prod(shape)) for _, shape, _, _ in layout)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, start = {}, 0
    for name, shape, mean, std in layout:
        n = int(np.prod(shape))
        out[name] = flat[start : start + n].view(shape).mul_(std).add_(mean)
        start += n
    if family(model) == "resnet":
        from portbench.reference import resnet

        resnet.calibrate_batchnorm(out, calibration_images(model, seed, device), model)
    return out


# Photo-like images whose statistics the ResNet's BatchNorm statistics are
# set from: the photo parameters of traffic/index_coco640.json (COCO
# val2017's 4:3 photos), made at the model's input size as CLIP's resize
# and centre crop would leave them.
CALIBRATION_PHOTO = dict(amplitudes=[40, 24, 20, 40], cells=[4, 16, 80, 320], noise=12)
CALIBRATION_IMAGES = 16


def calibration_images(model: dict, seed: int, device):
    """``CALIBRATION_IMAGES`` photo-like images of the model's input size,
    normalized by CLIP's mean and std, (B, S, S, 3) float32, drawn from
    the seed apart from the traffic's photos."""
    import torch

    from portbench.reference.image import MEAN, STD

    s = model["image_size"]
    w = s * 4 // 3
    px = photo_batch(sub_seed(seed, "calibration"), 0,
                     dict(CALIBRATION_PHOTO, height=s, width=w), device)
    lo = (w - s) // 2
    x = torch.as_tensor(px[:CALIBRATION_IMAGES, :, lo : lo + s], device=device,
                        dtype=torch.float32)
    return (x - torch.as_tensor(MEAN, device=device, dtype=torch.float32)) / torch.as_tensor(
        STD, device=device, dtype=torch.float32)


# -- the library's rows -----------------------------------------------------

ROW_CHUNK = 1 << 18


def library_rows(rows: int, dim: int, seed: int, device, start: int = 0,
                 count: int | None = None):
    """Rows ``start .. start+count`` of the library: unit Gaussian rows
    rounded to bfloat16, made on ``device`` chunk by chunk (each chunk
    from its own generator, so any block is made again alone)."""
    import torch

    count = rows - start if count is None else count
    out = torch.empty((count, dim), dtype=torch.bfloat16, device=device)
    c0 = start // ROW_CHUNK
    for c in range(c0, -(-(start + count) // ROW_CHUNK)):
        lo, hi = c * ROW_CHUNK, min((c + 1) * ROW_CHUNK, rows)
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, f"rows:{c}"))
        x = torch.randn(hi - lo, dim, generator=gen, device=device)
        x = (x / torch.linalg.norm(x, dim=1, keepdim=True)).to(torch.bfloat16)
        a, b = max(lo, start), min(hi, start + count)
        out[a - start : b - start] = x[a - lo : b - lo]
    return out


def row_metadata(row: int, path: str) -> dict:
    """The metadata stored with a library row. ``mtime`` carries the row's
    number, which ``/search`` echoes, so the check can tell rows apart
    although many rows share a photo."""
    return {"path": path, "mtime": float(row), "size": 1}


def write_library(folder: Path, rows: int, dim: int, seed: int, photos: list[str],
                  device, writer_cls, model_name: str, index_folder_name: str) -> None:
    """The library as the program stores it, written through its
    ``IndexWriter`` (``writer_cls``): row r points at photo r mod
    len(photos)."""
    w = writer_cls.create(folder, model=model_name, dim=dim, dtype_name="bfloat16",
                          rows_per_shard=ROW_CHUNK, index_folder_name=index_folder_name)
    for start in range(0, rows, ROW_CHUNK):
        n = min(ROW_CHUNK, rows - start)
        bits = library_rows(rows, dim, seed, device, start, n).view(
            __import__("torch").int16).cpu().numpy().view(np.uint16)
        ids = range(start, start + n)
        paths = [photos[r % len(photos)] for r in ids]
        meta = [row_metadata(r, p) for r, p in zip(ids, paths)]
        w.append(bits, paths, meta)
    w.finalize()


# -- photo-like JPEGs ---------------------------------------------------------

PHOTO_BATCH = 64


def photo_batch(seed: int, batch: int, photo: dict, device) -> np.ndarray:
    """Photos ``batch * PHOTO_BATCH ..`` of the set as (PHOTO_BATCH, height,
    width, 3) uint8, made on ``device`` from the seed in a few large
    calls: a base colour, smooth random fields at several scales (bicubic
    upsampling of random grids of ``cells`` columns) and mild white noise,
    so that their JPEGs decode at a photo's entropy cost."""
    import torch
    import torch.nn.functional as F

    h, w, n = photo["height"], photo["width"], PHOTO_BATCH
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, f"photos:{batch}"))
    x = 128.0 + 30.0 * torch.randn(n, 3, 1, 1, generator=gen, device=device)
    x = x.expand(n, 3, h, w).clone()
    for amp, cells in zip(photo["amplitudes"], photo["cells"]):
        grid = torch.randn(n, 3, max(cells * h // w, 1) + 1, cells + 1, generator=gen,
                           device=device)
        x += amp * F.interpolate(grid, size=(h, w), mode="bicubic", align_corners=False)
    x += photo["noise"] * torch.randn(n, 3, h, w, generator=gen, device=device)
    return x.round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def photo_path(folder, i: int) -> str:
    return str(Path(folder) / f"p_{i:05d}.jpg")


def _encode(path: str, arr: np.ndarray, quality: int) -> int:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    data = buf.getvalue()
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def _encoder(conn, quality: int) -> None:
    """A worker process: JPEG-encodes the raw photos it is sent (a header,
    then the pixels as raw bytes) until it is sent None; then sends back
    the sizes it wrote."""
    sizes = []
    while True:
        head = conn.recv()
        if head is None:
            conn.send(sizes)
            return
        path, shape = head
        sizes.append(_encode(path, np.frombuffer(conn.recv_bytes(), np.uint8).reshape(shape),
                             quality))


def write_photos(folder, count: int, seed: int, photo: dict, workers: int, device,
                 only=None) -> tuple[list[str], float]:
    """The set's first ``count`` photos as JPEGs (or only those numbered
    in ``only``), made on ``device`` and encoded by ``workers`` spawned
    processes, each fed raw pixels over a pipe of its own; returns every
    photo's path and the mean size in bytes of those written."""
    import multiprocessing

    Path(folder).mkdir(parents=True, exist_ok=True)
    want = set(range(count)) if only is None else set(only)
    ctx = multiprocessing.get_context("spawn")
    pipes, procs = [], []
    for _ in range(max(workers, 1)):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_encoder, args=(child, photo["quality"]), daemon=True)
        proc.start()
        child.close()
        pipes.append(parent)
        procs.append(proc)
    try:
        n = 0
        for b in range(-(-count // PHOTO_BATCH)):
            lo = b * PHOTO_BATCH
            if not want & set(range(lo, lo + PHOTO_BATCH)):
                continue
            arrs = photo_batch(seed, b, photo, device)
            for j in range(min(PHOTO_BATCH, count - lo)):
                if lo + j in want:
                    conn = pipes[n % len(pipes)]
                    conn.send((photo_path(folder, lo + j), arrs[j].shape))
                    conn.send_bytes(memoryview(np.ascontiguousarray(arrs[j])).cast("B"))
                    n += 1
        sizes = []
        for conn in pipes:
            conn.send(None)
            sizes.extend(conn.recv())
    finally:
        for conn, proc in zip(pipes, procs):
            conn.close()
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [photo_path(folder, i) for i in range(count)], float(np.mean(sizes))
