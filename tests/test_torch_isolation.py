"""ccmh_torch, chip_smoke.py and the port's tools stand alone: no JAX,
nothing of ccmh.

The machine with the card has no jax (nor regex, Pillow, ftfy, optax,
orbax), so the port keeps its own copies of what it needs from ccmh.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN_ROOTS = ("jax", "jaxlib", "ccmh", "optax", "orbax", "regex", "PIL", "ftfy")


def _port_files():
    # the port's scripts under tools/ run on the card's machine too
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += glob.glob(os.path.join(REPO, "tools", "*torch*.py"))
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
