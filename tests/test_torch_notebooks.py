"""The port's notebooks (``notebooks/torch/``): each runs on the CPU when
its parameters cell is overridden, and on ``cuda`` when it is not; none
imports the JAX package; each opens with its parameters cell and then
its model cell; each binds every name its JAX notebook binds; and
``scripts/make_torch_stats_notebooks.py`` writes the ten stats notebooks
byte for byte.

The notebooks run in process through ``chip_smoke.run_notebook`` (no
Jupyter), in a sandbox whose ``$REWRITING_TPU_WEIGHTS`` is empty, with the
zoo's URLs at a closed loopback port, so each takes its tiny seeded
branch.  The stats notebooks are cut to 4 images
by a cell run after their model cell, as the card's phase 40 cuts them to
32; their generators and segmenters keep their own widths.
"""

import ast
import importlib.util
import json
import pathlib
import sys

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_NOTEBOOKS = ROOT / "notebooks"
PORT_NOTEBOOKS = ROOT / "notebooks" / "torch"
NAMES = tuple(chip_smoke.NOTEBOOKS)
CPU_IMAGES = 4
# names the JAX notebooks bind that a port notebook need not: the JAX
# modules themselves, and PIL where the JAX notebook made PIL images only
# to display them (the port's ``show`` takes uint8 arrays)
NOT_CARRIED = {"jax", "jnp"}
DISPLAY_ONLY_PIL = ("stats/segmentation-stats", "stats/face-label-stats",
                    "stats/folder-segmentation")
# the calls of a model cell that build a generator, each on `device`
BUILDERS = ("load_seq_stylegan", "load_proggan", "SeqStyleGAN2",
            "ProgressiveGenerator")


@pytest.fixture(autouse=True)
def closed_publication_servers():
    """The port's zoo and mask registry URLs at a loopback port nothing
    listens on: a notebook's missing checkpoint fails its download at
    once, reaching no other host, and the notebook takes its tiny
    branch."""
    with chip_smoke.publication_urls(chip_smoke.closed_url()):
        yield


def code_cells(path):
    with open(path) as f:
        return [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]


def source(cell) -> str:
    return "".join(cell["source"])


def bound_names(tree) -> set:
    """The names a module binds at its top level: through compound
    statements, not inside functions, classes, lambdas or
    comprehensions."""
    names = set()

    def targets(node):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                targets(elt)
        elif isinstance(node, ast.Starred):
            targets(node.value)

    def walk(stmts):
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
                continue
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    names.add(alias.asname or alias.name.split(".")[0])
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    targets(target)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets(node.target)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                targets(node.target)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        targets(item.optional_vars)
            elif isinstance(node, ast.Try):
                for handler in node.handlers:
                    if handler.name:
                        names.add(handler.name)
                    walk(handler.body)
            for field in ("body", "orelse", "finalbody"):
                walk(getattr(node, field, []) or [])

    walk(tree.body)
    return names


def notebook_names(path) -> set:
    return set().union(*(bound_names(ast.parse(source(c)))
                         for c in code_cells(path)))


def jax_notebooks():
    return sorted(p.relative_to(JAX_NOTEBOOKS).with_suffix("").as_posix()
                  for p in JAX_NOTEBOOKS.rglob("*.ipynb")
                  if PORT_NOTEBOOKS not in p.parents)


@pytest.mark.parametrize("name", NAMES)
def test_notebook_runs_on_the_cpu(name, tmp_path):
    """Every code cell runs, on the CPU, to finite results (those phase 40
    checks on the card)."""
    overrides = {0: "device = 'cpu'"}
    if name.startswith("stats/"):
        overrides[1] = f"n_images = min(n_images, {CPU_IMAGES})"
    weights = tmp_path / "weights"
    weights.mkdir()
    with chip_smoke.notebook_sandbox(
            REWRITING_TPU_WEIGHTS=str(weights),
            REWRITING_TPU_MASKS=chip_smoke.MASKS):
        ns = chip_smoke.run_notebook(str(PORT_NOTEBOOKS / f"{name}.ipynb"),
                                     overrides)
    assert ns["device"] == "cpu"
    assert ns["model"].device == torch.device("cpu")
    for expr in chip_smoke.NOTEBOOKS[name][1]:
        value = eval(expr, ns)
        assert chip_smoke.finite_values(value), (name, expr)
    if name == "rewriting-interface":    # the tiny branch's edit moved it
        assert ns["real_weights"] is False
        assert not torch.equal(ns["gw"].target_weight(),
                               ns["gw"].original_params[
                                   ns["gw"].weight_stage()]["weight"])


@pytest.mark.parametrize("name", NAMES)
def test_notebook_asks_for_cuda_unless_told(name, tmp_path):
    """Run as saved, the model cell asks for ``cuda`` on both branches:
    where the card is missing, that raises, and nothing falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cells = code_cells(PORT_NOTEBOOKS / f"{name}.ipynb")
    ns = {"__name__": "__main__"}
    with chip_smoke.notebook_sandbox(REWRITING_TPU_WEIGHTS=str(tmp_path)):
        exec(source(cells[0]), ns)
        assert ns["device"] == "cuda"
        with pytest.raises(RuntimeError, match="CUDA was asked for"):
            exec(source(cells[1]), ns)


@pytest.mark.parametrize("name", NAMES)
def test_notebook_layout_and_imports(name):
    """No cell imports jax or the JAX package.  The first code cell is the
    parameters cell (tagged as papermill reads it) and sets only
    ``device = "cuda"``; the second, the model cell, builds the generator
    and its params on ``device`` and catches only ``FileNotFoundError``."""
    cells = code_cells(PORT_NOTEBOOKS / f"{name}.ipynb")
    for cell in cells:
        text = source(cell)
        assert "rewriting_tpu" not in text
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in mods)
    params, model = cells[0], cells[1]
    assert params["metadata"].get("tags") == ["parameters"]
    assert all("tags" not in c["metadata"] for c in cells[1:])
    tree = ast.parse(source(params))
    assert len(tree.body) == 1 and \
        ast.unparse(tree.body[0]) == "device = 'cuda'"
    tree = ast.parse(source(model))
    assert {"model", "params"} <= bound_names(tree)
    builds = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in BUILDERS]
    assert builds
    for call in builds:
        assert any(k.arg == "device" and getattr(k.value, "id", None) ==
                   "device" for k in call.keywords), ast.unparse(call)
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            assert [ast.unparse(h.type) for h in node.handlers] == \
                ["FileNotFoundError"]
    # nothing in any cell names the CPU: only the parameters cell's
    # override moves a notebook there
    for cell in cells:
        assert not any(isinstance(node, ast.Constant) and node.value == "cpu"
                       for node in ast.walk(ast.parse(source(cell))))


def test_every_jax_notebook_has_its_counterpart():
    """Each of the twelve JAX notebooks has a port notebook of the same
    relative name, and the port notebook binds at its top level every name
    the JAX notebook binds (less the JAX modules)."""
    names = jax_notebooks()
    assert len(names) == 12
    assert sorted(NAMES) == names
    assert sorted(p.relative_to(PORT_NOTEBOOKS).with_suffix("").as_posix()
                  for p in PORT_NOTEBOOKS.rglob("*.ipynb")) == names
    for name in names:
        want = notebook_names(JAX_NOTEBOOKS / f"{name}.ipynb") - NOT_CARRIED
        if name in DISPLAY_ONLY_PIL:
            want -= {"PIL"}
        missing = want - notebook_names(PORT_NOTEBOOKS / f"{name}.ipynb")
        assert not missing, (name, sorted(missing))


def test_bound_names_walks_compound_statements():
    tree = ast.parse("import a.b as c, d.e\nfrom f import g\n"
                     "try:\n    x, (y, *z) = 1, (2, 3)\n"
                     "except OSError as err:\n    w = 0\n"
                     "for i in []:\n    if 1:\n        v += 1\n"
                     "with open('p') as fh:\n    pass\n"
                     "def fn(q):\n    inner = q\n"
                     "[k for k in ()]\nlam = lambda u: u\n")
    assert bound_names(tree) == {"c", "d", "g", "x", "y", "z", "err", "w",
                                 "i", "v", "fh", "fn", "lam"}


def test_stats_generator_writes_the_committed_notebooks():
    """``scripts/make_torch_stats_notebooks.py`` reproduces the ten
    committed stats notebooks byte for byte, and writes nothing else."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_stats_notebooks",
        ROOT / "scripts" / "make_torch_stats_notebooks.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    committed = sorted(p.name for p in (PORT_NOTEBOOKS / "stats").iterdir())
    assert committed == sorted(gen.GENERATED)
    assert len(committed) == 10
    for name, build in gen.GENERATED.items():
        assert gen.dumps(build()) == \
            (PORT_NOTEBOOKS / "stats" / name).read_text(), name


@pytest.mark.parametrize("name", NAMES)
def test_notebook_saved_without_outputs(name):
    """Each notebook is stored as the repo's clean filter
    (``notebooks/ipynb_strip_output.py``) leaves it."""
    sys.path.insert(0, str(JAX_NOTEBOOKS))
    try:
        from ipynb_strip_output import strip
    finally:
        sys.path.remove(str(JAX_NOTEBOOKS))
    text = (PORT_NOTEBOOKS / f"{name}.ipynb").read_text()
    assert json.dumps(strip(json.loads(text)), indent=1,
                      sort_keys=True) + "\n" == text


def test_smoke_slice18_fails_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import smoke_slice18
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert smoke_slice18.main() != 0
    assert "no CUDA device" in capsys.readouterr().err
