"""Build a browsable HTML documentation site from docs/*.md.

The reference ships a Sphinx autodoc build (`docs/source/index.rst` ->
readthedocs HTML); this image has no sphinx, so this builder produces the
equivalent artifact from the markdown sources with the stdlib + the
`markdown` package: one styled HTML page per doc, a generated index with
a navigation sidebar, and `.md` cross-links rewritten to `.html`.

The API reference is regenerated from docstrings first (via
`gen_api_docs.generate()`), so the built site is always current.

Run:  python docs/build_html.py         (writes docs/html/, not committed)
Test: tests/test_docs.py::test_html_docs_build builds into a tmp dir and
      checks the pages render with their cross-links resolved.
"""
import argparse
import html
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import markdown

DOCS_DIR = os.path.dirname(os.path.abspath(__file__))

# (source file, nav title) in sidebar order
PAGES = [
    ("index.md", "Overview"),            # synthesized below
    ("design.md", "Architecture & design"),
    ("protocol.md", "Protocol & reference quirks"),
    ("api.md", "API guide"),
    ("migration.md", "Migrating from stochQN"),
    ("r_bindings.md", "R bindings"),
    ("api_reference.md", "API reference (generated)"),
]

_TEMPLATE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — stochqn_tpu</title>
<style>
:root {{ --fg: #1a1a1a; --bg: #ffffff; --accent: #0b5d8a; --dim: #667; }}
* {{ box-sizing: border-box; }}
body {{ margin: 0; color: var(--fg); background: var(--bg);
       font: 16px/1.55 system-ui, -apple-system, "Segoe UI", sans-serif; }}
nav {{ position: fixed; top: 0; left: 0; bottom: 0; width: 240px;
      overflow-y: auto; padding: 1.2rem 1rem; border-right: 1px solid #ddd;
      background: #f7f8fa; }}
nav h1 {{ font-size: 1.05rem; margin: 0 0 .8rem; }}
nav a {{ display: block; padding: .25rem 0; color: var(--dim);
        text-decoration: none; font-size: .92rem; }}
nav a.current {{ color: var(--accent); font-weight: 600; }}
nav a:hover {{ color: var(--accent); }}
main {{ margin-left: 240px; padding: 1.5rem 2.5rem 4rem;
       max-width: 60rem; }}
h1, h2, h3 {{ line-height: 1.25; }}
h2 {{ border-bottom: 1px solid #e3e5e8; padding-bottom: .25rem;
     margin-top: 2rem; }}
a {{ color: var(--accent); }}
code {{ background: #f0f1f3; padding: .1em .3em; border-radius: 3px;
       font-size: .9em; }}
pre {{ background: #f6f8fa; padding: .8rem 1rem; border-radius: 6px;
      overflow-x: auto; line-height: 1.4; }}
pre code {{ background: none; padding: 0; }}
table {{ border-collapse: collapse; display: block; overflow-x: auto; }}
th, td {{ border: 1px solid #d5d8dc; padding: .35rem .6rem;
         text-align: left; font-size: .92rem; }}
th {{ background: #f0f1f3; }}
@media (max-width: 900px) {{
  nav {{ position: static; width: auto; border-right: none;
        border-bottom: 1px solid #ddd; }}
  main {{ margin-left: 0; padding: 1rem; }}
}}
</style>
</head>
<body>
<nav>
<h1>stochqn_tpu</h1>
{nav}
</nav>
<main>
{body}
</main>
</body>
</html>
"""

_INDEX_MD = """# stochqn_tpu documentation

Stochastic limited-memory quasi-Newton optimizers: oLBFGS, SQN and
adaQN re-designed for JAX/XLA — fused `lax.scan`
training epochs, sharded two-loop recursion, a protocol-compatible
free-mode API, a scikit-learn-style guided layer, a header-only C++17
native tier with Python (ctypes) and R bindings, and measured parity +
performance against the reference `stochQN` C core.

Start with [Architecture & design](design.md), or jump straight to the
[generated API reference](api_reference.md). Reference users: see
[Migrating from stochQN](migration.md) and the
[protocol quirk list](protocol.md).

Measured numbers live in the repository root (`PERF.md`); this site
covers concepts and APIs.
"""


def _nav(current):
    items = []
    for fname, title in PAGES:
        href = fname.replace(".md", ".html")
        cls = ' class="current"' if fname == current else ""
        items.append(f'<a href="{href}"{cls}>{html.escape(title)}</a>')
    return "\n".join(items)


def _rewrite_links(text):
    # [x](foo.md) / [x](foo.md#anchor) -> .html; leave http(s) alone
    return re.sub(r"\]\((?!https?://)([\w./-]+)\.md(#[\w-]*)?\)",
                  r"](\1.html\2)", text)


def _render(md_text, title, current):
    body = markdown.markdown(
        _rewrite_links(md_text),
        extensions=["fenced_code", "tables", "toc"])
    return _TEMPLATE.format(title=html.escape(title), nav=_nav(current),
                            body=body)


def build(out_dir):
    os.makedirs(out_dir, exist_ok=True)

    # regenerate the API reference from docstrings so the site is current
    import gen_api_docs
    api_md = gen_api_docs.generate()
    with open(os.path.join(DOCS_DIR, "api_reference.md"), "w") as f:
        f.write(api_md)

    written = []
    for fname, title in PAGES:
        if fname == "index.md":
            text = _INDEX_MD
        else:
            with open(os.path.join(DOCS_DIR, fname)) as f:
                text = f.read()
        page = _render(text, title, fname)
        out_path = os.path.join(out_dir, fname.replace(".md", ".html"))
        with open(out_path, "w") as f:
            f.write(page)
        written.append(out_path)
    return written


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(DOCS_DIR, "html"))
    args = ap.parse_args()
    for path in build(args.out):
        print(f"wrote {path}")
