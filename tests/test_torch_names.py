"""Every public name of a reference module that has a port file is ported
or documented: it is defined, imported or assigned at the top of the port
file, or the port file's docstring names it (in double backquotes, as
``core/trainer.py`` names what has no counterpart, beside what replaces
it). A reference module's public names are its ``__all__``, else its
top-level functions, classes and assignments without a leading
underscore. Both files are read with ``ast``: nothing is imported."""
import ast
import re
from pathlib import Path

import pytest

import torch

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1] / "src"
REF, PORT = ROOT / "repro", ROOT / "repro_torch"
PAIRS = sorted(p.relative_to(REF) for p in REF.rglob("*.py")
               if (PORT / p.relative_to(REF)).is_file())


def _top_names(tree):
    """Names bound at the top of a module: defs, classes, assignments and
    imports."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def public_names(path):
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    return {n for n in _top_names(tree) if not n.startswith("_")
            and not any(isinstance(node, (ast.Import, ast.ImportFrom))
                        and n in {(a.asname or a.name).split(".")[0]
                                  for a in node.names}
                        for node in tree.body)}


def covered_names(path):
    tree = ast.parse(path.read_text())
    doc = ast.get_docstring(tree) or ""
    return _top_names(tree) | set(re.findall(r"``([A-Za-z_]\w*)``", doc))


def test_every_port_file_is_paired():
    assert len(PAIRS) > 50
    assert Path("kernels/flash_attention/ops.py") in PAIRS


@pytest.mark.parametrize("rel", PAIRS, ids=str)
def test_reference_names_are_ported_or_documented(rel):
    missing = sorted(public_names(REF / rel) - covered_names(PORT / rel))
    assert not missing, (f"src/repro_torch/{rel} neither has nor documents "
                         f"{missing}")
