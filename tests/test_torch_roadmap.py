"""Every ROADMAP.md queue A title that the port quotes (its
``NotImplementedError`` messages, ``train.py``'s ``_ROADMAP``, docstrings)
is the title of an item of that queue, word for word, so that a user who
meets a refusal finds the item it names."""

import ast
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "coala_gnn_tpu_torch")
CITE = re.compile(r'ROADMAP\.md\s+queue\s+A,\s*"([^"]+)"')


def _port_strings():
    """(file, string) for every string literal of the port's Python files;
    ``ast`` joins adjacent literals, so a title split over two lines of
    source reads whole."""
    for dirpath, _, files in sorted(os.walk(PORT)):
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as fh:
                    tree = ast.parse(fh.read(), path)
                for node in ast.walk(tree):
                    if isinstance(node, ast.Constant) and isinstance(
                            node.value, str):
                        yield os.path.relpath(path, ROOT), node.value


def _cited_titles():
    """{(file, title)} of every queue A title the port quotes, whitespace
    collapsed (docstrings wrap lines)."""
    return {(path, " ".join(title.split()))
            for path, text in _port_strings()
            for title in CITE.findall(text)}


def _queue_a_titles():
    """The bold titles of ROADMAP.md section A (its numbered items and its
    "Not ported" list), without their closing full stop."""
    with open(os.path.join(ROOT, "ROADMAP.md")) as fh:
        text = fh.read()
    section = text.split("### A.", 1)[1].split("### B.", 1)[0]
    return {" ".join(t.split()).rstrip(".")
            for t in re.findall(r"\*\*(.+?)\*\*", section, re.S)}


def test_quoted_queue_a_titles_exist():
    titles = _queue_a_titles()
    missing = sorted((path, title) for path, title in _cited_titles()
                     if title not in titles)
    assert not missing, missing


def test_the_scan_finds_the_citations():
    """The scan reads the CLI's table and a title split over two literals
    (not vacuous)."""
    cited = _cited_titles()
    train = {title for path, title in cited
             if path == os.path.join("coala_gnn_tpu_torch", "train.py")}
    assert train == {"Not ported: code the system does not need on a GPU"}
    # the hetero models, dedup / nbr_cap sampling and the checkpoint are
    # ported: nothing quotes their items any more
    assert not any(title in ("hetero models and typed sampling",
                             "dedup=True and nbr_cap sampling",
                             "checkpoint and rng")
                   for _, title in cited)
    # the resident pipeline over ranks is ported: nothing quotes the
    # multi-GPU item any more; nor, since stage_overlap and
    # insert_rows(return_evicted) are ported, the staged miss path's
    assert not any(title == "multi-GPU" for _, title in cited)
    staged = "the staged miss path: fused lookup / overlay, and what stays"
    for name in ("sharded_resident.py", "sharded_cache.py"):
        assert (os.path.join("coala_gnn_tpu_torch", "parallel", name),
                staged) not in cited
    # the real datasets are ported: only ogbn-* is refused, by the loader
    assert not any(title == "the real datasets" for _, title in cited)
    assert (os.path.join("coala_gnn_tpu_torch", "graph", "datasets.py"),
            "Not ported: code the system does not need on a GPU") in cited

