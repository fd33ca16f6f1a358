"""The load generator, run as a child process of the benchmark so that it
shares no interpreter lock with the server:

    python -m portbench.client <spec.json> <out.json>

``spec["kind"]``:

* ``search``: an open loop. Request i is due at ``t0 + offset_i``
  (``time.monotonic``, one clock for every process of the machine); a
  dispatcher hands it at that moment to one of ``workers`` threads, each
  of which opens a connection, POSTs ``/search`` and reads the whole
  response. Latency runs from when the request was due to its last byte,
  so a stall also delays the requests queued behind it. For the requests
  in ``sample``, the rows (their ``mtime``) and similarities of the
  answer are kept for the check.
* ``index``: ``POST /index`` of ``folders`` one after the other, from
  ``t0``, each started while less than ``seconds`` have passed. Past the
  last folder the first ones are indexed again, their index removed
  first, so that every pass indexes a fresh folder.

Writes one JSON object to ``out.json``.
"""

from __future__ import annotations

import http.client
import json
import queue
import re
import sys
import threading
import time

_ROW = re.compile(rb'"metadata": \{"mtime": ([^,]+), "size": [^}]*\}, "similarity": ([^,}]+)')


def _post(port: int, path: str, body: dict, timeout: float) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def run_search(spec: dict) -> dict:
    reqs, port, t0 = spec["requests"], spec["port"], spec["t0"]
    sample = set(spec["sample"])
    n = len(reqs)
    sent = [0.0] * n
    done = [0.0] * n
    status = [0] * n
    count = [0] * n
    rows: dict[int, list] = {}
    todo: "queue.Queue" = queue.Queue()

    def worker():
        while True:
            i = todo.get()
            if i is None:
                return
            offset, text, limit = reqs[i]
            sent[i] = time.monotonic() - t0
            try:
                code, data = _post(port, "/search", {
                    "folder": spec["folder"], "query": text, "limit": limit,
                    "sort_by": "similarity"}, spec["timeout_s"])
            except OSError:
                code, data = 0, b""
            done[i] = time.monotonic() - t0
            status[i] = code
            count[i] = data.count(b'"similarity": ')
            if i in sample and code == 200:
                rows[i] = [[float(m), float(s)] for m, s in _ROW.findall(data)]

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(spec["workers"])]
    for t in threads:
        t.start()
    for i, (offset, _, _) in enumerate(reqs):
        wait = t0 + offset - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        todo.put(i)
    for _ in threads:
        todo.put(None)
    deadline = time.monotonic() + spec["drain_s"]
    for t in threads:
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    return {"sent": sent, "done": done, "status": status, "count": count,
            "rows": {str(i): r for i, r in rows.items()}}


def run_index(spec: dict) -> dict:
    import itertools
    import os
    import shutil

    t0, passes = spec["t0"], []
    wait = t0 - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    for n in itertools.count():
        folder = spec["folders"][n % len(spec["folders"])]
        start = time.monotonic() - t0
        if start >= spec["seconds"]:
            break
        if n >= len(spec["folders"]):
            shutil.rmtree(os.path.join(folder, spec["index_folder_name"]))
        try:
            code, data = _post(spec["port"], "/index", {"folder": folder}, spec["timeout_s"])
            body = json.loads(data) if code == 200 else {}
        except (OSError, ValueError):
            code, body = 0, {}
        passes.append({"folder": folder, "start": start, "end": time.monotonic() - t0,
                       "status": code, "count": int(body.get("count", 0))})
    return {"passes": passes}


def main(argv: list[str]) -> int:
    with open(argv[0]) as f:
        spec = json.load(f)
    out = (run_search if spec["kind"] == "search" else run_index)(spec)
    with open(argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
