#!/usr/bin/env python
"""Generate browsable API docs for zpix and optionally serve them.

The reference build graph has first-class docs steps: `zig build docs`
emits autodocs and `zig build serve-docs` serves them over HTTP
(/root/reference/build.zig:94-143, /root/reference/serveDocs.zig:10-120).
This tool is the counterpart: stdlib pydoc renders every module's
docstrings (which carry the design rationale and reference citations)
into docs/api/, with an index page, and --serve mirrors the reference's
HTTP server step.

Usage:
    python tools/gen_docs.py             # write docs/api/*.html
    python tools/gen_docs.py --serve     # generate + serve on :8000
    python tools/gen_docs.py --serve --port 9090
"""

from __future__ import annotations

import argparse
import importlib
import os
import pkgutil
import pydoc
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "docs", "api")

# docs generation never opens the GPU: force the CPU backend in case a
# module touches jax at import time (one process per card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, REPO)


def iter_modules():
    import zpix

    yield "zpix"
    for m in pkgutil.walk_packages(zpix.__path__, prefix="zpix."):
        yield m.name


def generate() -> list[str]:
    os.makedirs(OUT, exist_ok=True)
    written = []
    cwd = os.getcwd()
    os.chdir(OUT)  # pydoc.writedoc writes into the cwd
    try:
        for name in iter_modules():
            try:
                importlib.import_module(name)
                pydoc.writedoc(name)
                written.append(name)
            except Exception as e:  # document what imports; report the rest
                print(f"  skip {name}: {e}", file=sys.stderr)
    finally:
        os.chdir(cwd)
    rows = "\n".join(
        f'<li><a href="{n}.html"><code>{n}</code></a></li>'
        for n in sorted(written)
    )
    with open(os.path.join(OUT, "index.html"), "w") as f:
        f.write(
            "<!doctype html><meta charset='utf-8'>"
            "<title>zpix API docs</title>"
            "<h1>zpix API documentation</h1>"
            "<p>Generated from module docstrings by tools/gen_docs.py "
            "(counterpart of the reference's <code>zig build docs</code> "
            "step).</p><ul>" + rows + "</ul>"
        )
    return written


def serve(port: int) -> None:
    import functools
    import http.server

    handler = functools.partial(
        http.server.SimpleHTTPRequestHandler, directory=OUT
    )
    print(f"serving docs on http://127.0.0.1:{port}/ (ctrl-c to stop)")
    http.server.ThreadingHTTPServer(("127.0.0.1", port), handler).serve_forever()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true",
                    help="serve docs/api over HTTP after generating")
    ap.add_argument("--port", type=int, default=8000)
    args = ap.parse_args()
    n = len(generate())
    print(f"wrote {n} module pages + index to {OUT}")
    if args.serve:
        serve(args.port)
