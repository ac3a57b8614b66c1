"""ccmh_torch, chip_smoke.py and the port's tools stand alone: no JAX,
nothing of ccmh.

The machine with the card has no jax (nor regex, Pillow, ftfy, optax,
orbax), so the port keeps its own copies of what it needs from ccmh.
"""

import ast
import glob
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN_ROOTS = ("jax", "jaxlib", "ccmh", "optax", "orbax", "regex", "PIL", "ftfy")


def _port_files():
    # the port's scripts under tools/ and examples/ run on the card's
    # machine too
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += glob.glob(os.path.join(REPO, "tools", "*torch*.py"))
    files += glob.glob(os.path.join(REPO, "examples", "*torch*.py"))
    for root, _, names in os.walk(os.path.join(REPO, "ccmh_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_import_leaves_no_jax_or_ccmh_module():
    code = (
        "import sys\n"
        "sys.modules['regex'] = None\n"
        "import ccmh_torch, ccmh_torch.serve, ccmh_torch.retrieval\n"
        "import ccmh_torch.train.methods.dchmt, ccmh_torch.train.checkpoint\n"
        "import ccmh_torch.clip.convert, ccmh_torch.tokenizer.bpe\n"
        "import ccmh_torch.cli, ccmh_torch.train.trainer, ccmh_torch.train.optim\n"
        "import ccmh_torch.train.state, ccmh_torch.ops.map_metric\n"
        "import ccmh_torch.ops.similarity, ccmh_torch.losses.dchmt\n"
        "import ccmh_torch.data.dataset, ccmh_torch.data.split, ccmh_torch.data.synthetic\n"
        "import ccmh_torch.utils.logger, ccmh_torch.utils.xlsx, ccmh_torch.ops.layernorm\n"
        "import ccmh_torch.ops.attention_variants, ccmh_torch.tools.bench_attn_bwd\n"
        "import ccmh_torch.losses.dnph_tomm, ccmh_torch.losses.twdh, ccmh_torch.losses.dpbe\n"
        "import ccmh_torch.losses.dghdgh, ccmh_torch.train.methods.dnph_tomm\n"
        "import ccmh_torch.train.methods.twdh, ccmh_torch.train.methods.dpbe\n"
        "import ccmh_torch.train.methods.dghdgh\n"
        "import ccmh_torch.ops.pr_curve, ccmh_torch.ops.recall, ccmh_torch.clip.hf\n"
        "import ccmh_torch.clip.import_ref, ccmh_torch.clip.export_ref\n"
        "import ccmh_torch.tokenizer.native, ccmh_torch.data.native\n"
        "import ccmh_torch.data.cache, ccmh_torch.data.prefetch, ccmh_torch.data.resident\n"
        "import ccmh_torch.clip.resnet, ccmh_torch.data.builders\n"
        "import ccmh_torch.data.builders.make_coco, ccmh_torch.data.builders.make_nuswide\n"
        "import ccmh_torch.data.builders.make_mirflickr25k\n"
        "import ccmh_torch.data.builders.twdh_centers\n"
        "import ccmh_torch.parallel, ccmh_torch.parallel.mesh, ccmh_torch.parallel.tp\n"
        "import ccmh_torch.parallel.fsdp\n"
        "import ccmh_torch.tools.floors, ccmh_torch.tools.step_split\n"
        "from ccmh_torch.retrieval import _demo\n"
        "from ccmh_torch.train.methods import PORTED, get_method, EXPECTED_METHODS\n"
        "[get_method(EXPECTED_METHODS[m]) for m in PORTED]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ccmh', 'optax', 'orbax', 'PIL'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            # ftfy stays an optional import of the tokenizer, as in ccmh
            if root == "ftfy" and path.endswith("bpe.py"):
                continue
            assert root not in FORBIDDEN_ROOTS, f"{path}:{node.lineno} imports {name}"


def _string_constants(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                  if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                                       ast.AsyncFunctionDef))
                  and node.body and isinstance(node.body[0], ast.Expr)
                  and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            yield node
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "join":
            for arg in node.args:
                if isinstance(arg, ast.Constant) and arg.value == "ccmh":
                    yield arg


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_port_file_names_a_path_under_ccmh(path):
    """No string of the port's code (docstrings and comments aside) names a
    path in ccmh's tree, so no source is read or built from there."""
    for node in _string_constants(path):
        # a "file:line" citation of ccmh's code (chip_smoke.py's "replaces"
        # column) names no path the code opens
        text = re.sub(r"ccmh/[\w/.]+\.py:\d+", "", node.value.replace("\\", "/"))
        assert text != "ccmh" and "ccmh/" not in text.replace("ccmh_torch/", ""), (
            f"{path}:{node.lineno} names {node.value!r}")


def test_host_libraries_build_under_the_ignored_build_directory(tmp_path, monkeypatch):
    """The native tokenizer and image loader build from the port's own
    sources into build/ccmh_torch_host/ (git-ignored), named by a hash of
    the source and the flags."""
    from ccmh_torch.data import native as loader
    from ccmh_torch.tokenizer import native as bpe
    from ccmh_torch.utils import host_build

    port = os.path.join(REPO, "ccmh_torch")
    for mod in (bpe, loader):
        assert os.path.dirname(mod.SRC).startswith(port + os.sep), mod.SRC
    assert host_build.BUILD_DIR == os.path.join(REPO, "build", "ccmh_torch_host")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "build/" in fh.read().split()
    decoder, flags = loader.build_flags()
    lib = host_build.build(loader.SRC, f"loader_{decoder}", flags)
    assert os.path.dirname(lib) == host_build.BUILD_DIR
    assert host_build.library_path(loader.SRC, "x", flags) != host_build.library_path(
        loader.SRC, "x", flags + ("-DOTHER",))
    src = tmp_path / "bpe.cpp"
    src.write_bytes(open(bpe.SRC, "rb").read())
    before = host_build.library_path(str(src), "bpe", bpe.FLAGS)
    with open(src, "a") as fh:
        fh.write("\n// edited\n")
    assert host_build.library_path(str(src), "bpe", bpe.FLAGS) != before
    assert not [n for n in os.listdir(os.path.dirname(bpe.SRC)) if n.endswith(".so")]
    assert not [n for n in os.listdir(os.path.dirname(loader.SRC)) if n.endswith(".so")]


def test_package_data_ships_the_kernel_sources_and_vocab():
    """The CUDA sources are built at first use from the installed package,
    so every package-data glob of ccmh_torch must match real files."""
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        data = tomllib.load(fh)["tool"]["setuptools"]["package-data"]["ccmh_torch"]
    for pattern in data:
        assert glob.glob(os.path.join(REPO, "ccmh_torch", pattern)), pattern
    from ccmh_torch.ops import build

    for name in build.KERNELS:
        assert os.path.isfile(os.path.join(build.CSRC_DIR, f"{name}.cu")), name


def test_kernel_build_is_keyed_on_the_sources(tmp_path, monkeypatch):
    """Libraries live under the checkout's build/ (git-ignored) and their
    names carry a hash of the source and shared headers, so an edited
    kernel rebuilds; with no nvcc the build raises instead of falling back."""
    from ccmh_torch.ops import build

    assert build.BUILD_DIR == os.path.join(REPO, "build", "ccmh_torch_kernels")
    paths = {name: build.library_path(name) for name in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in os.listdir(build.CSRC_DIR):
        (csrc / name).write_bytes(open(os.path.join(build.CSRC_DIR, name), "rb").read())
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    assert build.library_path("attention") == paths["attention"]
    with open(csrc / "common.cuh", "a") as fh:
        fh.write("\n// edited\n")
    assert build.library_path("attention") != paths["attention"]
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
