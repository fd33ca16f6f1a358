"""Server entry point: ``python -m evossearch_tpu_torch.server [--port N]
[--device cuda|cpu]`` (the GPU unless the CPU is asked for).

Mirrors the reference startup sequence (oldapp.py:2255-2258): init model,
print the startup banner, serve blocking.
"""

import argparse

from ..core import config
from ..engine import SearchEngine
from .app import create_app
from .web import serve


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="evossearch-tpu-torch")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first GPU)")
    args = parser.parse_args(argv)
    if args.host:
        config.HOST = args.host
    if args.port:
        config.PORT = args.port

    engine = SearchEngine(cfg=config, device=args.device)
    _ = engine.params  # load/initialize model weights up front (init_clip analog)
    engine.warmup()  # run text/image paths once before accepting requests
    app = create_app(engine=engine, cfg=config)
    config.print_startup_info()
    serve(app, config.HOST, config.PORT, debug=config.DEBUG)


if __name__ == "__main__":
    main()
