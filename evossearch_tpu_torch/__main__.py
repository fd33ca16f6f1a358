"""Command-line interface: ``python -m evossearch_tpu_torch <command>``
(or the ``evossearch-tpu-torch`` script).

The same commands and the same JSON output as the JAX package's CLI:
index a folder (once, or ``--watch``ing it), search it by text or by an
example image, serve HTTP, prebuild the SQ8 sidecar, convert an OpenAI /
HuggingFace checkpoint to the native npz, fine-tune the towers
contrastively on a captioned folder (``train``). ``--device`` picks the
torch device (default: the first GPU; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def _folder_fingerprint(folder, extensions) -> list[tuple]:
    """(path, mtime, size) for every candidate image, in scan order."""
    from .index.builder import scan_folder

    fp = []
    for p in scan_folder(folder, extensions):
        try:
            st = p.stat()
        except OSError:
            continue
        fp.append((str(p), st.st_mtime, st.st_size))
    return fp


def watch_folder(
    engine, folder: str, interval_s: float, max_cycles: int | None = None
) -> int:
    """Poll ``folder`` every ``interval_s`` seconds and incrementally
    re-index when any file is added, removed, or modified. Runs until
    interrupted (or ``max_cycles`` polls, for tests); returns the number
    of re-index runs performed."""
    import time

    exts = engine.cfg.SUPPORTED_EXTENSIONS

    def indexed_fingerprint():
        """What the LIVE INDEX covers — the baseline must be the index,
        not the current folder, so changes made before watch started
        still trigger a run."""
        _, reader = engine._cached_index(folder)
        if reader is None or not reader.metadata:
            return []
        return sorted(
            (m["path"], m["mtime"], m["size"]) for m in reader.metadata
        )

    last = indexed_fingerprint()
    runs = 0
    cycles = 0
    print(f"watching {folder} every {interval_s:g}s (ctrl-c to stop)",
          file=sys.stderr)
    while max_cycles is None or cycles < max_cycles:
        cycles += 1
        try:
            time.sleep(interval_s)
        except KeyboardInterrupt:
            break
        current = sorted(_folder_fingerprint(folder, exts))
        if current == last:
            continue
        try:
            count = engine.index_folder(folder, incremental=True)
            runs += 1
            print(json.dumps({"success": True, "count": count,
                              "watch_run": runs}), flush=True)
        except Exception as e:  # keep watching; the next change retries
            print(f"watch re-index failed: {e}", file=sys.stderr)
            continue
        # Baseline becomes the FOLDER fingerprint that triggered this run
        # (not the index's): an undecodable file is in the folder forever
        # but never in the index, and an index-based baseline would
        # re-index every cycle.
        last = current
    return runs


def _parser() -> argparse.ArgumentParser:
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument(
        "--device", default=argparse.SUPPRESS,
        help="torch device (default: the first GPU; 'cpu' for the CPU)",
    )
    parser = argparse.ArgumentParser(prog="evossearch_tpu_torch", parents=[device])
    sub = parser.add_subparsers(dest="command", required=True)

    def add(name, **kw):
        return sub.add_parser(name, parents=[device], **kw)

    p_index = add("index", help="(re)index an image folder")
    p_index.add_argument("folder")
    p_index.add_argument("--resume", action="store_true",
                         help="resume a crashed indexing run")
    p_index.add_argument("--incremental", action="store_true",
                         help="reuse embeddings of unchanged files")
    p_index.add_argument("--watch", type=float, default=0, metavar="SECONDS",
                         help="keep running: poll the folder every N "
                              "seconds and incrementally re-index when "
                              "files change")

    p_search = add("search", help="text search an indexed folder")
    p_search.add_argument("folder")
    p_search.add_argument("query")
    p_search.add_argument("-k", type=int, default=12)

    p_similar = add("similar", help="find images similar to a file")
    p_similar.add_argument("folder")
    p_similar.add_argument("image")
    p_similar.add_argument("-k", type=int, default=12)

    p_serve = add("serve", help="run the HTTP server")
    p_serve.add_argument("--host", default=None)
    p_serve.add_argument("--port", type=int, default=None)

    p_train = add("train", help="contrastive fine-tune on <folder>/captions.json")
    p_train.add_argument("folder")
    p_train.add_argument("--epochs", type=int, default=1)
    p_train.add_argument("--batch-size", type=int, default=32)
    p_train.add_argument("--lr", type=float, default=1e-5)
    p_train.add_argument("--out", default="ckpts", help="checkpoint dir")
    p_train.add_argument("--resume", action="store_true")
    p_train.add_argument("--init-from", default=None)
    p_train.add_argument("--model", default=None)

    p_sq8 = add(
        "sq8",
        help="prebuild the SQ8 capacity-tier sidecar for an indexed "
             "folder (otherwise it builds on the first over-budget query; "
             "no device needed)",
    )
    p_sq8.add_argument("folder")
    p_sq8.add_argument("--force", action="store_true",
                       help="rebuild even when a fresh sidecar exists")

    p_conv = add(
        "convert",
        help="convert an OpenAI .pt / HF CLIP checkpoint to the native "
             ".npz format (then set EVOSSEARCH_CHECKPOINT to use it)",
    )
    p_conv.add_argument("src", help="OpenAI .pt file or HF model directory")
    p_conv.add_argument("out", help="output .npz path")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    device = getattr(args, "device", None)

    if args.command == "train":
        return _train(args, device)

    if args.command == "convert":
        from .models.checkpoint import save_params
        from .models.convert import load_checkpoint

        params, spec = load_checkpoint(args.src)
        written = save_params(args.out, params, spec)
        n_params = sum(int(p.size) for p in _tree_leaves(params))
        print(json.dumps({
            "success": True, "model": spec.name, "params": n_params,
            "out": str(written),
        }))
        return 0

    from .core import config

    if args.command == "sq8":
        import time

        from .index.sq8 import SQ8Index
        from .index.store import IndexReader

        reader = IndexReader.open(args.folder, config.INDEX_FOLDER_NAME)
        if reader is None:
            print("Folder not indexed", file=sys.stderr)
            return 1
        mt = reader.mtime()
        if not args.force:
            smt = SQ8Index.sidecar_mtime(reader)
            if smt is not None and smt >= mt and SQ8Index.load(
                reader, store_mtime=mt
            ) is not None:
                print(json.dumps(
                    {"success": True, "count": reader.count, "built": False}
                ))
                return 0
        t0 = time.time()
        SQ8Index.build_from_reader(
            reader, fetch=config.SQ8_FETCH, store_mtime=mt
        )
        print(json.dumps({
            "success": True, "count": reader.count, "built": True,
            "seconds": round(time.time() - t0, 1),
        }))
        return 0

    if args.command == "serve":
        from .server.__main__ import main as serve_main

        serve_argv = []
        if args.host:
            serve_argv += ["--host", args.host]
        if args.port:
            serve_argv += ["--port", str(args.port)]
        if device:
            serve_argv += ["--device", device]
        serve_main(serve_argv)
        return 0

    from .engine import SearchEngine

    engine = SearchEngine(cfg=config, device=device)
    try:
        return _run(engine, args)
    finally:
        engine.close()


def _train(args, device) -> int:
    """The JAX CLI's ``train``, on ``device``, in float32."""
    from .core import CLIP_MODEL_SPECS, config
    from .models.checkpoint import load_params, params_from_numpy
    from .tokenizer import load_tokenizer
    from .train import PairDataset, fit

    name = args.model or config.CLIP_MODEL
    if name not in CLIP_MODEL_SPECS:
        print(f"unknown CLIP model {name!r}; available: "
              f"{', '.join(CLIP_MODEL_SPECS)}", file=sys.stderr)
        return 1
    spec = CLIP_MODEL_SPECS[name]
    if spec.family == "resnet":
        print(f"{name} is a ResNet-family model; contrastive training "
              "supports the ViT family only (frozen inference BatchNorm "
              "— see train/contrastive.py)", file=sys.stderr)
        return 1
    params = None
    if args.init_from:
        tree, loaded_spec = load_params(args.init_from)
        if loaded_spec != spec:
            print(f"--init-from checkpoint is {loaded_spec.name}, "
                  f"not {name}", file=sys.stderr)
            return 1
        params = params_from_numpy(tree, spec, device)
    tokenizer = load_tokenizer(config.BPE_VOCAB_PATH or None)
    try:
        dataset = PairDataset(args.folder, tokenizer, spec, batch_size=args.batch_size)
    except (OSError, ValueError) as e:  # no captions.json, or none of its files
        print(f"train: {e}", file=sys.stderr)
        return 1
    _, history = fit(
        spec, dataset, epochs=args.epochs, learning_rate=args.lr,
        params=params, checkpoint_dir=args.out, resume=args.resume,
        device=device,
    )
    losses = [float(h) for h in history]
    if not any(math.isfinite(v) for v in losses):
        # zero training batches (e.g. <2 decodable captioned images):
        # report the failure instead of success:true with a bare NaN
        # token that strict JSON parsers reject
        print(json.dumps({
            "success": False, "model": name,
            "error": "no trainable batches (need >= 2 decodable "
                     "captioned images per batch)",
        }))
        return 1
    print(json.dumps({
        "success": True, "model": name, "epochs": args.epochs,
        "loss_history": [round(v, 4) if math.isfinite(v) else None for v in losses],
        "checkpoint": f"{args.out}/clip.npz",
    }))
    return 0


def _run(engine, args) -> int:
    if args.command == "index":
        count = engine.index_folder(
            args.folder, resume=args.resume,
            incremental=args.incremental or None,
        )
        if count == 0 and not args.watch:
            print("No images found in folder", file=sys.stderr)
            return 1
        print(json.dumps({"success": True, "count": count}), flush=True)
        if args.watch:
            watch_folder(engine, args.folder, args.watch)
        return 0

    if args.command == "search":
        result = engine.search_text(args.folder, args.query, args.k)
    else:  # similar
        from PIL import Image

        with Image.open(args.image) as img:
            result = engine.search_image(args.folder, img, args.k)
    if result is None:
        print("Folder not indexed", file=sys.stderr)
        return 1
    scores, indices, reader = result
    for score, idx in zip(scores, indices):
        print(json.dumps(
            {"path": reader.paths[int(idx)], "similarity": float(score)}
        ))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
