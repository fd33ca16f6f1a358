"""HTTP API — reproduces the request/response contract of every reference
route (SURVEY.md §2-K; reference oldapp.py:188-2258), backed by the
port's engine (evossearch_tpu_torch.engine) instead of CLIP/FAISS.

Contract notes preserved verbatim from the reference, including quirks:
  * limit coerced to int; out-of-range or unparseable -> DEFAULT_RESULTS
    (oldapp.py:1985-1990)
  * `sort_by == "time"` re-sorts the retrieved top-k by mtime desc —
    retrieval itself is always by similarity (oldapp.py:2043-2045)
  * per-result thumbnail failures skip the result (oldapp.py:2038-2040)
  * /search_by_image takes `image` file XOR `image_path` form field, file
    wins; empty filename counts as no file (oldapp.py:2074-2081)
  * /settings POST validates and rewrites .env wholesale (oldapp.py:2182+)

One deliberate fix (SURVEY §2-K /image/ quirk): the reference 403s any
path starting with "/", which breaks serving indexed images on Linux
entirely. Here absolute paths are allowed, with two protections kept:
".." is rejected, and files are only served from folders that contain an
index (so the endpoint cannot be used to read arbitrary files).
"""

from __future__ import annotations

import os
import time
from pathlib import Path

from ..core import Config, config as default_config, write_env_file
from ..engine import SearchEngine
from ..index import (
    add_image_comment,
    get_image_comments,
    load_comments,
)
from ..utils import get_logger
from ..utils.profiling import capture_trace
from .thumbs import thumbnail_b64
from .web import (
    App, HTTPError, Request, Response, html_response, jsonify, send_file,
)

log = get_logger("server")


def _results_json(results: list[dict]) -> Response:
    """Serialize a results list, splicing the thumbnails in raw.

    Thumbnails are base64 JPEG strings (alphabet ``A-Za-z0-9+/=``), which
    JSON never needs to escape — yet ``json.dumps`` still scans every
    byte of a 12-result (~600 KB) response, GIL-serialized across
    serving threads (the JAX package measured it comparable to the device
    dispatch under load on its TPU host; on the H100 machine's host,
    building an answer's 1.7 MB of thumbnail JSON takes about 10 ms of
    Python a request).
    Splicing the cached b64 into the body avoids that scan; every other
    field (paths can contain anything) still goes through ``json.dumps``.
    Output parses identically.
    """
    import json

    parts = []
    for item in results:
        thumb = item.pop("thumbnail")
        frag = json.dumps(item)
        parts.append(f'{frag[:-1]}, "thumbnail": "{thumb}"}}')
    body = '{"results": [' + ", ".join(parts) + "]}"
    return Response(
        body=body.encode("utf-8"), content_type="application/json"
    )


def _result_options_html(cfg: Config) -> str:
    """Result-limit <option> generation (oldapp.py:191-224 semantics)."""
    options = {cfg.MIN_RESULTS, cfg.DEFAULT_RESULTS, cfg.MAX_RESULTS}
    if cfg.MAX_RESULTS <= 20:
        for i in range(cfg.MIN_RESULTS, cfg.MAX_RESULTS + 1):
            if i % 2 == 0 or i % 3 == 0:
                options.add(i)
    else:
        for i in (6, 12, 18, 24, 30):
            if cfg.MIN_RESULTS <= i <= cfg.MAX_RESULTS:
                options.add(i)
    return "\n                            ".join(
        f'<option value="{i}" {"selected" if i == cfg.DEFAULT_RESULTS else ""}>{i}</option>'
        for i in sorted(options)
    )


def _validated_limit(raw, cfg: Config) -> int:
    try:
        limit = int(raw)
        if limit < cfg.MIN_RESULTS or limit > cfg.MAX_RESULTS:
            return cfg.DEFAULT_RESULTS
        return limit
    except (ValueError, TypeError):
        return cfg.DEFAULT_RESULTS


def create_app(engine: SearchEngine | None = None, cfg: Config | None = None,
               device=None) -> App:
    """The HTTP app over ``engine``, or over a new engine on ``device``
    (the GPU unless ``"cpu"`` is asked for; see core.resolve_device)."""
    cfg = cfg or default_config
    engine = engine or SearchEngine(cfg=cfg, device=device)
    # +1 MiB headroom over the configured max upload for multipart framing
    # and form fields.
    app = App(
        "evossearch-tpu",
        max_body_bytes=cfg.MAX_FILE_SIZE_MB * 1024 * 1024 + 1024 * 1024,
    )
    app.engine = engine  # exposed for tests
    app.cfg = cfg

    def _result_item(path: str, metadata: dict | None, extra: dict) -> dict | None:
        """Shared result-row builder; None when thumbnailing fails."""
        try:
            thumb = thumbnail_b64(path, cfg.THUMBNAIL_SIZE, cfg.THUMBNAIL_QUALITY)
        except Exception as e:
            log.warning("Error processing image %s: %s", path, e)
            return None
        meta_info = {}
        if metadata:
            meta_info = {
                "mtime": metadata.get("mtime", 0),
                "size": metadata.get("size", 0),
            }
        return {
            "path": path,
            "filename": os.path.basename(path),
            "thumbnail": thumb,
            "metadata": meta_info,
            **extra,
        }

    def _search_response(result, sort_by: str):
        """(scores, indices, reader) -> {'results': [...]} per contract."""
        scores, indices, reader = result
        results = []
        for idx, sim in zip(indices, scores):
            idx = int(idx)
            if not (0 <= idx < len(reader.paths)):
                continue
            meta = (
                reader.metadata[idx]
                if reader.metadata and idx < len(reader.metadata)
                else None
            )
            item = _result_item(
                reader.paths[idx], meta, {"similarity": float(sim)}
            )
            if item is not None:
                results.append(item)
        if sort_by == "time" and reader.metadata:
            results.sort(key=lambda x: x["metadata"].get("mtime", 0), reverse=True)
        return _results_json(results)

    # ---- frontend ----

    @app.route("/")
    def home(request: Request):
        from .frontend import render_page

        html = render_page(_result_options_html(cfg), str(int(time.time())))
        return html_response(
            html,
            headers={
                "Cache-Control": "no-cache, no-store, must-revalidate",
                "Pragma": "no-cache",
                "Expires": "0",
            },
        )

    # ---- image serving ----

    @app.route("/image/<path:filepath>")
    def serve_image(request: Request, filepath: str):
        try:
            if ".." in filepath:
                return html_response("Access denied", 403)
            abs_path = os.path.abspath(filepath)
            if not os.path.exists(abs_path) or not os.path.isfile(abs_path):
                return html_response("Image not found", 404)
            # Serve ONLY files that are rows of an index: anyone who can
            # POST can index a folder, so "folder has an index" alone would
            # still expose non-image files (dotfiles, configs) in indexed
            # folders. O(1) row-membership probe (not an O(corpus) path
            # set — VERDICT r3 #5) is the contract the frontend needs
            # (it only requests result paths).
            if not engine.index_contains(str(Path(abs_path).parent), abs_path):
                return html_response("Access denied", 403)
            return send_file(abs_path)
        except Exception as e:
            return html_response(f"Error serving image: {e}", 500)

    # ---- comments (component G) ----

    @app.route("/comments", methods=("GET",))
    def get_comments(request: Request):
        folder = request.args.get("folder")
        image_path = request.args.get("image_path")
        if not folder or not image_path:
            return jsonify({"error": "Missing folder or image_path parameter"}, 400)
        try:
            comments = get_image_comments(folder, image_path, cfg.INDEX_FOLDER_NAME)
            return jsonify({"comments": comments})
        except Exception as e:
            log.warning("Error getting comments: %s", e)
            return jsonify({"error": str(e)}, 500)

    @app.route("/comments", methods=("POST",))
    def save_comment(request: Request):
        data = request.json or {}
        folder = data.get("folder")
        image_path = data.get("image_path")
        comment = (data.get("comment") or "").strip()
        if not folder or not image_path or not comment:
            return jsonify({"error": "Missing folder, image_path, or comment"}, 400)
        if len(comment) > cfg.MAX_COMMENT_LENGTH:
            return jsonify(
                {"error": f"Comment too long (max {cfg.MAX_COMMENT_LENGTH} characters)"},
                400,
            )
        try:
            ok = add_image_comment(folder, image_path, comment, cfg.INDEX_FOLDER_NAME)
            if ok:
                comments = get_image_comments(
                    folder, image_path, cfg.INDEX_FOLDER_NAME
                )
                return jsonify({"success": True, "comments": comments})
            return jsonify({"error": "Failed to save comment"}, 500)
        except Exception as e:
            log.warning("Error saving comment: %s", e)
            return jsonify({"error": str(e)}, 500)

    @app.route("/commented_images", methods=("POST",))
    def commented_images(request: Request):
        folder = (request.json or {}).get("folder")
        if not folder:
            return jsonify({"error": "No folder specified"}, 400)
        try:
            # cached reader (one manifest stat) — a full open_index would
            # re-parse O(corpus) JSON per request. Cache miss falls back
            # to open_index so unmigrated legacy-FAISS folders still get
            # migrated on first touch of this route.
            entry, reader = engine._cached_index(folder)
            if reader is None:
                entry, reader = {}, engine.open_index(folder)
            if reader is None:
                return jsonify({"error": "Folder not indexed"}, 400)
            comments_data = load_comments(folder, cfg.INDEX_FOLDER_NAME)
            # the engine's cached path->row map (shared with /image/
            # membership and stored_embedding) — rebuilding it here cost
            # O(corpus) per request on the 1-core host
            path_to_idx = engine._path_rows(entry, reader)
            results = []
            for image_path, comment_list in comments_data.items():
                idx = path_to_idx.get(image_path)
                if idx is None:  # only images still in the index
                    continue
                meta = (
                    reader.metadata[idx]
                    if reader.metadata and idx < len(reader.metadata)
                    else None
                )
                item = _result_item(
                    image_path,
                    meta,
                    {
                        "comment_count": len(comment_list),
                        "latest_comment": comment_list[-1] if comment_list else "",
                    },
                )
                if item is not None:
                    results.append(item)
            # newest-comment-first == lexicographic desc on the timestamp
            # prefix (oldapp.py:1938)
            results.sort(key=lambda x: x["latest_comment"], reverse=True)
            return _results_json(results)
        except Exception as e:
            log.warning("Error getting commented images: %s", e)
            return jsonify({"error": str(e)}, 500)

    # ---- indexing ----

    @app.route("/check_index", methods=("POST",))
    def check_index(request: Request):
        folder = (request.json or {}).get("folder")
        if not folder:
            return jsonify({"error": "No folder specified"}, 400)
        return jsonify({"indexed": engine.is_indexed(folder)})

    @app.route("/index", methods=("POST",))
    def index_folder(request: Request):
        folder = (request.json or {}).get("folder")
        if not folder or not os.path.exists(folder):
            return jsonify({"error": "Invalid folder path"}, 400)
        try:
            with capture_trace():  # torch.profiler capture when PROFILE_DIR is set
                count = engine.index_folder(folder)
            if count == 0:
                return jsonify({"error": "No images found in folder"}, 400)
            return jsonify({"success": True, "count": count})
        except Exception as e:
            return jsonify({"error": str(e)}, 500)

    # ---- search ----

    @app.route("/search", methods=("POST",))
    def search(request: Request):
        data = request.json or {}
        folder = data.get("folder")
        query = data.get("query")
        limit = _validated_limit(data.get("limit", 10), cfg)
        sort_by = data.get("sort_by", "similarity")
        log.info("Search request: folder=%s, query=%s, limit=%s, sort_by=%s",
                 folder, query, limit, sort_by)
        if not folder or not query:
            return jsonify({"error": "Missing folder or query"}, 400)
        if not engine.is_indexed_fast(folder):
            return jsonify({"error": "Folder not indexed"}, 400)
        try:
            with capture_trace():  # torch.profiler capture when PROFILE_DIR is set
                result = engine.search_text(folder, query, limit)
            if result is None:
                return jsonify({"error": "Folder not indexed"}, 400)
            if len(result[0]) == 0:
                return jsonify({"results": []})
            return _search_response(result, sort_by)
        except Exception as e:
            log.warning("Text search error: %s", e)
            import traceback

            traceback.print_exc()
            return jsonify({"error": str(e)}, 500)

    @app.route("/search_by_image", methods=("POST",))
    def search_by_image(request: Request):
        folder = request.form.get("folder")
        limit = _validated_limit(request.form.get("limit", 12), cfg)
        sort_by = request.form.get("sort_by", "similarity")
        if not folder:
            return jsonify({"error": "Missing folder"}, 400)
        file = request.files.get("image")
        image_path = request.form.get("image_path")
        if file is not None and file.filename == "":
            file = None
        if file is None and not image_path:
            return jsonify({"error": "No image uploaded or path provided"}, 400)
        if not engine.is_indexed_fast(folder):
            return jsonify({"error": "Folder not indexed"}, 400)
        try:
            from PIL import Image

            with capture_trace():  # torch.profiler capture when PROFILE_DIR is set
                if file is not None:
                    uploaded = Image.open(file.stream)
                    if uploaded.mode != "RGB":
                        uploaded = uploaded.convert("RGB")
                    # device row: the search dispatch chains on device,
                    # one blocking fetch for the whole encode+search chain
                    query_emb = engine.encode_image_device(uploaded)
                else:
                    if not os.path.exists(image_path):
                        return jsonify(
                            {"error": f"Image file not found: {image_path}"}, 400
                        )
                    # Find-similar short-circuit: if the path is an indexed,
                    # unchanged file, its stored row equals what re-encoding
                    # would produce — skip the decode+encode dispatch.
                    query_emb = engine.stored_embedding(folder, image_path)
                    if query_emb is None:
                        try:
                            img = Image.open(image_path)
                            query_emb = engine.encode_image_device(img)
                        except Exception as path_error:
                            return jsonify(
                                {"error": "Error processing image from path: "
                                          f"{path_error}"},
                                400,
                            )
                result = engine.search_embedding(folder, query_emb, limit)
            if result is None:
                return jsonify({"error": "Folder not indexed"}, 400)
            if len(result[0]) == 0:
                return jsonify({"results": []})
            return _search_response(result, sort_by)
        except HTTPError:
            raise
        except Exception as e:
            return jsonify({"error": str(e)}, 500)

    # ---- settings (component J) ----

    @app.route("/settings", methods=("GET",))
    def get_settings(request: Request):
        try:
            settings = {
                "host": cfg.HOST,
                "port": cfg.PORT,
                "debug": cfg.DEBUG,
                "clipModel": cfg.CLIP_MODEL,
                "minResults": cfg.MIN_RESULTS,
                "maxResults": cfg.MAX_RESULTS,
                "defaultResults": cfg.DEFAULT_RESULTS,
                "batchSize": cfg.BATCH_SIZE,
                "thumbnailQuality": cfg.THUMBNAIL_QUALITY,
                "maxCommentLength": cfg.MAX_COMMENT_LENGTH,
                "maxFileSize": cfg.MAX_FILE_SIZE_MB,
                "indexFolderName": cfg.INDEX_FOLDER_NAME,
            }
            return jsonify({"success": True, "settings": settings})
        except Exception as e:
            return jsonify({"success": False, "error": str(e)}, 500)

    @app.route("/settings", methods=("POST",))
    def save_settings(request: Request):
        try:
            data = request.json
            if not data:
                return jsonify({"success": False, "error": "No data provided"}, 400)
            required = (
                "host", "port", "debug", "clipModel",
                "minResults", "maxResults", "defaultResults",
            )
            for field in required:
                if field not in data:
                    return jsonify(
                        {"success": False, "error": f"Missing required field: {field}"},
                        400,
                    )
            # String values are interpolated into the generated .env; a
            # newline would inject arbitrary EVOSSEARCH_* keys parsed at
            # the next startup.
            for key, value in data.items():
                if isinstance(value, str) and ("\n" in value or "\r" in value):
                    return jsonify(
                        {"success": False,
                         "error": f"Invalid value for {key}: newlines not allowed"},
                        400,
                    )
            try:
                port = int(data["port"])
                if not (1000 <= port <= 65535):
                    return jsonify(
                        {"success": False,
                         "error": "Port must be between 1000 and 65535"},
                        400,
                    )
                min_results = int(data["minResults"])
                max_results = int(data["maxResults"])
                default_results = int(data["defaultResults"])
                if not (1 <= min_results <= max_results):
                    return jsonify(
                        {"success": False,
                         "error": "Min results must be less than or equal to max results"},
                        400,
                    )
                if not (min_results <= default_results <= max_results):
                    return jsonify(
                        {"success": False,
                         "error": "Default results must be between min and max results"},
                        400,
                    )
            except ValueError as e:
                return jsonify(
                    {"success": False, "error": f"Invalid number format: {e}"}, 400
                )
            write_env_file(data, ".env")
            return jsonify(
                {"success": True,
                 "message": "Settings saved successfully. Restart the server to "
                            "apply changes."}
            )
        except Exception as e:
            return jsonify({"success": False, "error": str(e)}, 500)

    # ---- observability (no reference counterpart; SURVEY §5) ----

    @app.route("/stats", methods=("GET",))
    def stats(request: Request):
        return jsonify(
            {
                "counters": engine.counters.snapshot(),
                "stage_timers": engine.timers.snapshot(),
                "model": engine.spec.name,
                "hbm": engine.hbm_snapshot(),
            }
        )

    return app
