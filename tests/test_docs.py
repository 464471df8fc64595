"""The checked-in API reference must match the live public surface."""
import os
import sys


def test_api_reference_is_current():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "docs"))
    try:
        import gen_api_docs
    finally:
        sys.path.pop(0)
    generated = gen_api_docs.generate()
    with open(os.path.join(repo, "docs", "api_reference.md")) as f:
        checked_in = f.read()
    assert generated == checked_in, (
        "docs/api_reference.md is stale — regenerate with "
        "`python docs/gen_api_docs.py`")


def test_html_docs_build(tmp_path):
    """`python docs/build_html.py` produces the browsable site (the
    counterpart of the reference's Sphinx build) with every page
    rendered, the sidebar present, and .md cross-links rewritten."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "docs"))
    try:
        import build_html
    finally:
        sys.path.pop(0)
    written = build_html.build(str(tmp_path))
    names = {os.path.basename(p) for p in written}
    assert {"index.html", "design.html", "protocol.html", "api.html",
            "migration.html", "r_bindings.html",
            "api_reference.html"} <= names
    api = (tmp_path / "api_reference.html").read_text()
    assert "FusedTrainer" in api and 'class="current"' in api
    assert "](design.md)" not in api
    idx = (tmp_path / "index.html").read_text()
    assert 'href="api_reference.html"' in idx
