"""`palette_and_histo_gan_tpu_torch/kernels/table.py` lists every TPU kernel
of the repository.

An AST scan of every Python file of the repository outside the port,
`build/` and `tests/` finds each call whose function is `pallas_call`
(an assignment such as `_orig = pl.pallas_call` is no call); the set of
their sites, with the function around each, must equal the table's. Each
row's kernel body must be a function that the reaching function names,
and its port's source and wrapper must exist. `chip_smoke.py` reports each
kernel's `replaces` from the table, holding no copy of its own.
"""

import ast
import importlib
import os

from palette_and_histo_gan_tpu_torch.kernels import table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIP_DIRS = {"palette_and_histo_gan_tpu_torch", "build", "tests"}


def repository_sources():
    for root, dirs, files in os.walk(REPO):
        if root == REPO:
            dirs[:] = [d for d in dirs if d not in SKIP_DIRS]
        dirs[:] = sorted(d for d in dirs if not d.startswith((".", "__pycache__")))
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)


def parse(rel: str) -> ast.Module:
    with open(os.path.join(REPO, rel)) as f:
        return ast.parse(f.read(), rel)


class PallasCalls(ast.NodeVisitor):
    """'file:line' of every call whose function is `pallas_call` -> the
    innermost function around it ("<module>" outside any)."""

    def __init__(self, rel: str):
        self.rel, self.stack, self.sites = rel, ["<module>"], {}

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        f = node.func
        if (f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)) == "pallas_call":
            self.sites[f"{self.rel}:{node.lineno}"] = self.stack[-1]
        self.generic_visit(node)


def pallas_call_sites(sources=None) -> dict[str, str]:
    sites = {}
    for path in sources or repository_sources():
        visitor = PallasCalls(os.path.relpath(path, REPO))
        visitor.visit(parse(visitor.rel))
        sites.update(visitor.sites)
    return sites


def test_the_table_lists_every_pallas_call_of_the_repository():
    found = pallas_call_sites()
    assert len(found) == 9, found
    assert found == {k.site: k.reaches for k in table.KERNELS}


def test_the_scan_sees_calls_and_not_assignments():
    visitor = PallasCalls("example.py")
    visitor.visit(ast.parse(
        "import functools as ft\n"
        "def f():\n    _orig = pl.pallas_call\n    pl.pallas_call = ft.partial(_orig)\n"
        "def g():\n    return pl.pallas_call(kernel)(x)\n"
        "y = pallas_call(kernel)\n"))
    assert visitor.sites == {"example.py:6": "g", "example.py:7": "<module>"}
    graft = pallas_call_sites([os.path.join(REPO, "__graft_entry__.py")])
    assert graft == {}  # its `_orig_pallas_call = pl.pallas_call` is an assignment


def test_each_row_names_its_body_source_and_wrapper():
    assert len({k.name for k in table.KERNELS}) == len(table.KERNELS) == 9
    assert table.BY_NAME["K6"].site == "scripts/bench_in_stats.py:63"
    for k in table.KERNELS:
        body_file, body_line = k.body.rsplit(":", 1)
        body = next(n for n in ast.walk(parse(body_file)) if isinstance(n, ast.FunctionDef)
                    and n.lineno == int(body_line))
        site_file = k.site.rsplit(":", 1)[0]
        reaching = next(n for n in ast.walk(parse(site_file)) if isinstance(n, ast.FunctionDef)
                        and n.name == k.reaches)
        assert body_file == site_file
        assert body.name in {n.id for n in ast.walk(reaching) if isinstance(n, ast.Name)}, k
        assert os.path.exists(os.path.join(REPO, k.source)), k
        module, function = k.entry.split("::")
        mod = importlib.import_module("palette_and_histo_gan_tpu_torch." + module[:-3].replace("/", "."))
        assert callable(getattr(mod, function)), k


def test_chip_smoke_reads_replaces_from_the_table():
    strings = {n.value for n in ast.walk(parse("chip_smoke.py"))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert not {k.body for k in table.KERNELS} & strings
