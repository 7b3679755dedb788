"""Generate the HTML API-reference tree for pyfocusr_tpu (docs/api/).

The reference ships a pdoc-generated HTML tree (/root/reference/docs/
pyfocusr/*.html); this produces the equivalent per-module reference for
this package using the stdlib ``pydoc`` HTML writer (pdoc itself is
not installable in the zero-egress image).  One page per module plus an
index; inter-module links work because pydoc emits dotted-name
filenames.

Usage:  python tools/make_api_docs.py  (or ``make docs``)
"""

from __future__ import annotations

import importlib
import os
import pkgutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "docs", "api")
sys.path.insert(0, ROOT)

# Force the CPU backend before anything imports jax: doc generation needs
# no accelerator.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pydoc  # noqa: E402


def iter_module_names() -> list[str]:
    import pyfocusr_tpu

    names = ["pyfocusr_tpu"]
    for info in pkgutil.walk_packages(
        pyfocusr_tpu.__path__, prefix="pyfocusr_tpu."
    ):
        if info.name.endswith("._native"):
            continue  # the C++ shared object is not an importable module
        names.append(info.name)
    return names


def _relativize(page: str) -> None:
    """pydoc links each module's source by absolute path; keep the pages
    free of the checkout's location."""
    with open(page) as f:
        html = f.read()
    html = html.replace("file:" + ROOT + os.sep, "../../").replace(
        ROOT + os.sep, "")
    with open(page, "w") as f:
        f.write(html)


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(OUT)  # pydoc.writedoc writes <name>.html into CWD
    written, failed = [], []
    try:
        for name in iter_module_names():
            try:
                mod = importlib.import_module(name)
                pydoc.writedoc(mod)
                _relativize(f"{name}.html")
                written.append(name)
            except Exception as exc:  # optional-dep modules must not kill docs
                failed.append((name, f"{type(exc).__name__}: {exc}"))
    finally:
        os.chdir(cwd)

    rows = "\n".join(
        f'<li><a href="{n}.html"><code>{n}</code></a></li>'
        for n in sorted(written)
    )
    with open(os.path.join(OUT, "index.html"), "w") as f:
        f.write(
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>pyfocusr_tpu API reference</title></head><body>"
            "<h1>pyfocusr_tpu API reference</h1>"
            "<p>Generated per-module reference (stdlib pydoc HTML; the "
            "reference ships the pdoc equivalent).  Hand-written guides: "
            '<a href="../api.md">api.md</a>, '
            '<a href="../architecture.md">architecture.md</a>, '
            '<a href="../tuning.md">tuning.md</a>.</p>'
            f"<ul>{rows}</ul></body></html>"
        )
    print(f"wrote {len(written)} module pages + index to {OUT}")
    for name, err in failed:
        print(f"  skipped {name}: {err}")
    return 0 if written else 1


if __name__ == "__main__":
    raise SystemExit(main())
