"""Graphviz views of a single tree's grandparent subtrees (port of
``rag_cobweb_tpu/utils/viz.py``, reference
``CobwebWrapper._visualize_grandparent_tree``).

One graph per "grandparent" node (a node with grandchildren): the
grandparent, its child clusters and their leaves' sentences in wrapped
boxes, ``num_leaves`` leaves a graph.  The DOT source is written here, so
the ``graphviz`` package is not needed; the ``dot`` binary renders it to
PNG where it is installed, and otherwise the source is kept as ``.dot``,
as the JAX package does.  Host code only.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import textwrap


def _sentence_label(sentences, sid, max_len=250, wrap=40):
    if sid is None or not (0 <= sid < len(sentences)):
        return None
    s = sentences[sid]
    if not s:
        return None
    if len(s) > max_len:
        s = s[:max_len].rstrip() + "..."
    return "\n".join(textwrap.wrap(s, wrap)) or None


def _quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n") + '"'


def _node(name: str, label: str, **attrs) -> str:
    kv = " ".join(f"{k}={_quote(v)}" for k, v in
                  [("label", label)] + list(attrs.items()))
    return f"\t{name} [{kv}]"


def grandparent_graphs(tree, sentences, sids_by_leaf,
                       num_leaves: int = 6) -> list:
    """(name, DOT source) of every graph, in the JAX package's order:
    grandparents by a depth-first walk from the root, each one's leaves in
    batches of ``num_leaves``."""
    a = tree.host_arrays()
    ch, nc = a["children"], a["n_children"]

    def children(n):
        return [int(ch[n, i]) for i in range(int(nc[n]))]

    def leaf_label(n):
        for sid in sids_by_leaf.get(n, []):
            lbl = _sentence_label(sentences, sid)
            if lbl:
                return lbl
        return None

    grandparents = []
    stack = [int(a["root"])]
    while stack:
        n = stack.pop()
        kids = children(n)
        grand = [g for c in kids for g in children(c)]
        if grand and any(leaf_label(g) for g in grand):
            grandparents.append(n)
        stack.extend(kids)

    graphs = []
    for gp in grandparents:
        parent_map = {}
        all_leaves = []
        for c in children(gp):
            valid = [g for g in children(c) if leaf_label(g)]
            if valid:
                parent_map[c] = valid
                all_leaves.extend(valid)
        batches = [all_leaves[i:i + num_leaves]
                   for i in range(0, len(all_leaves), num_leaves)]
        for bi, batch in enumerate(batches):
            gp_id = f"gp{gp}"
            lines = ["// Grandparent Subtree", "digraph {", "\trankdir=TB",
                     "\tedge [color=lightblue]",
                     _node(gp_id, "", shape="circle", width="0.5",
                           style="filled", color="lightblue")]
            for c, leaves in parent_map.items():
                sel = [lf for lf in leaves if lf in batch]
                if not sel:
                    continue
                cid = f"p{c}"
                lines += [_node(cid, "", shape="circle", width="0.25",
                                style="filled", color="#666666"),
                          f"\t{gp_id} -> {cid}"]
                for lf in sel:
                    lines += [_node(f"l{lf}", leaf_label(lf), shape="box",
                                    style="filled", color="lightgrey"),
                              f"\t{cid} -> l{lf}"]
            tag = hashlib.sha1(str(gp).encode()).hexdigest()[:8]
            graphs.append((f"gp_{gp}_{tag}_{bi}", "\n".join(lines + ["}"])
                           + "\n"))
    return graphs


def visualize_grandparent_subtrees(tree, sentences, sids_by_leaf,
                                   output_dir: str, num_leaves: int = 6):
    """Write each grandparent graph into ``output_dir`` as PNG (with the
    ``dot`` binary) or as its ``.dot`` source; returns the paths."""
    os.makedirs(output_dir, exist_ok=True)
    dot = shutil.which("dot")
    rendered = []
    for name, src in grandparent_graphs(tree, sentences, sids_by_leaf,
                                        num_leaves):
        path = os.path.join(output_dir, name)
        if dot is not None:
            subprocess.run([dot, "-Tpng", "-o", path + ".png"],
                           input=src.encode(), check=True)
            rendered.append(path + ".png")
        else:
            with open(path + ".dot", "w") as f:
                f.write(src)
            rendered.append(path + ".dot")
    return rendered
