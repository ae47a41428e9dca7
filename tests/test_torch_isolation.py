"""The port stands alone: no file of hydrium_tpu_torch (its parallel/
modules included), nor chip_smoke.py or the profile_*.py scripts, imports
the JAX package or jax; a CPU encode in both modes, a sharded and a
one-process multi-process encode load neither; and the constants it
copied equal the JAX package's."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hydrium_tpu.jxl import tokcode as jax_tokcode
from hydrium_tpu.ops import tables as jax_tables
from hydrium_tpu_torch.jxl import tokcode
from hydrium_tpu_torch.ops import tables

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("hydrium_tpu", "jax", "jaxlib")


def _port_files():
    files = sorted((REPO / "hydrium_tpu_torch").rglob("*.py"))
    return files + [REPO / name for name in ("chip_smoke.py",
                                             "profile_front.py",
                                             "profile_pack.py",
                                             "profile_prepare.py",
                                             "profile_tiled.py",
                                             "profile_transport.py")]


def _imported_roots(path: Path):
    """(line, top-level package) of every import in the file, at any
    depth (imports inside functions included); relative imports stay
    inside their package and are skipped."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in files for line, root in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_graph_module_is_scanned():
    """ops/graphs.py, the counterpart of the JAX package's jitted
    pipeline, is among the files scanned, and imports neither."""
    path = REPO / "hydrium_tpu_torch" / "ops" / "graphs.py"
    assert path in _port_files()
    roots = {root for _line, root in _imported_roots(path)}
    assert "torch" in roots and not roots & set(FORBIDDEN)


def test_native_sources_include_nothing_outside_the_port():
    """The port's C++ and CUDA sources (its native plane and its
    sanitizer self-test among them) include system headers, or files of
    their own directory tree, never the JAX package's cpp/."""
    csrc = REPO / "hydrium_tpu_torch" / "csrc"
    sources = sorted(p for p in csrc.rglob("*")
                     if p.suffix in (".cc", ".cu", ".h", ".cuh"))
    names = {p.relative_to(csrc).as_posix() for p in sources}
    assert {"host/serializer.cc", "host/selftest.cc"} <= names
    bad = []
    for p in sources:
        for line in p.read_text().splitlines():
            if line.startswith("#include") and '"' in line:
                target = (p.parent / line.split('"')[1]).resolve()
                if csrc.resolve() not in target.parents:
                    bad.append(f"{p.relative_to(REPO)}: {line}")
    assert not bad, bad


def test_scan_sees_imports_inside_functions(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n"
                   "def f():\n"
                   "    from hydrium_tpu.utils import djxl\n"
                   "    import jax.numpy\n"
                   "from . import x\n"
                   "import hydrium_tpu_torch\n")
    assert sorted(_imported_roots(src)) == [
        (1, "os"), (3, "hydrium_tpu"), (4, "jax"), (6, "hydrium_tpu_torch")]


def test_cpu_encode_loads_neither_jax_nor_the_jax_package(tmp_path):
    """encode_image in both modes, then the CLI on a PFM it wrote."""
    code = ("import sys, numpy as np, hydrium_tpu_torch as H\n"
            "from hydrium_tpu_torch import cli\n"
            "from hydrium_tpu_torch.utils.pfm import write_pfm\n"
            "img = np.random.default_rng(0).integers(0, 256, (300, 520, 3),"
            " dtype=np.uint8)\n"
            "for shift in (-1, 0):\n"
            "    b = H.encode_image(img, shift, device='cpu')\n"
            "    assert b[:2] == b'\\xff\\x0a', b[:2]\n"
            "write_pfm(sys.argv[1], (img / 255.0).astype(np.float32))\n"
            "assert cli.main([sys.argv[1], sys.argv[2], '--device', 'cpu',"
            " '--tile-size=0']) == 0\n"
            "assert open(sys.argv[2], 'rb').read(2) == b'\\xff\\x0a'\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('hydrium_tpu', 'jax', "
            "'jaxlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO),
               HYDRIUM_TORCH_WARM_CACHE=str(tmp_path / "warm.npz"))
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "in.pfm"), str(tmp_path / "o.jxl")],
                         cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_bench_loads_neither_jax_nor_the_jax_package(tmp_path):
    """The bench's rows and its device plane on the CPU, at a small
    crop."""
    code = ("import sys\n"
            "from hydrium_tpu_torch import bench\n"
            "assert bench.main(['1', '--device', 'cpu', '--crop', "
            "'64x200']) == 0\n"
            "assert bench.main(['1', '--device-plane', '--device', 'cpu', "
            "'--crop', '64x64']) == 0\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('hydrium_tpu', 'jax', "
            "'jaxlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               HYDRIUM_TORCH_WARM_CACHE=str(tmp_path / "warm.npz"))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert "hydrium_tpu_torch/bench.py" in names


def test_scale_loads_neither_jax_nor_the_jax_package(tmp_path):
    """hydrium_tpu_torch.scale's config 4 and the single-process
    reference of config 5 on the CPU, at small sizes."""
    code = ("import sys\n"
            "from hydrium_tpu_torch import scale\n"
            "r = scale.config4(64, 300, device='cpu')\n"
            "assert r['codestream_signature'], r\n"
            "ref = scale._streaming_reference(scale.SyntheticImage(300, 64),"
            " scale.resolve_device('cpu'), sys.argv[1])\n"
            "assert ref['bytes'] > 0, ref\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('hydrium_tpu', 'jax', "
            "'jaxlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               HYDRIUM_TORCH_WARM_CACHE=str(tmp_path / "warm.npz"))
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert "hydrium_tpu_torch/scale.py" in names


def test_parallel_modules_are_scanned():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for mod in ("multihost", "driver", "shard", "dryrun"):
        assert f"hydrium_tpu_torch/parallel/{mod}.py" in names, mod


def test_parallel_encodes_load_neither_jax_nor_the_jax_package(tmp_path):
    """encode_image_sharded over two CPU entries and a one-process
    encode_image_multihost."""
    code = ("import sys, numpy as np\n"
            "from hydrium_tpu_torch.parallel.driver import "
            "encode_image_sharded\n"
            "from hydrium_tpu_torch.parallel.multihost import "
            "encode_image_multihost\n"
            "img = np.random.default_rng(0).integers(0, 256, (40, 2100, 3),"
            " dtype=np.uint8)\n"
            "a = encode_image_sharded(img, ['cpu', 'cpu'])\n"
            "b = encode_image_multihost(img, device='cpu')\n"
            "assert a == b and a[:2] == b'\\xff\\x0a', a[:2]\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('hydrium_tpu', 'jax', "
            "'jaxlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               HYDRIUM_TORCH_WARM_CACHE=str(tmp_path / "warm.npz"))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_conformance_modules_are_scanned():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for rel in ("models/__init__.py", "models/profiles.py",
                "ops/hf_tokens.py", "ops/reference.py"):
        assert f"hydrium_tpu_torch/{rel}" in names, rel


def test_reference_copies_every_function_of_the_jax_package():
    import inspect

    from hydrium_tpu.ops import hf_tokens as jax_hf_tokens
    from hydrium_tpu.ops import reference as jax_reference
    from hydrium_tpu_torch.ops import hf_tokens, reference

    for mine, theirs in ((reference, jax_reference),
                         (hf_tokens, jax_hf_tokens)):
        want = {n for n, v in vars(theirs).items()
                if inspect.isfunction(v) and v.__module__ == theirs.__name__}
        got = {n for n, v in vars(mine).items()
               if inspect.isfunction(v) and v.__module__ == mine.__name__}
        assert got == want, (mine.__name__, want ^ got)


def test_conformance_encode_loads_neither_jax_nor_the_jax_package(tmp_path):
    """The numpy plane in both modes and through the CLI: no jax, no
    hydrium_tpu, and CUDA never initialized."""
    code = ("import sys, numpy as np, torch, hydrium_tpu_torch as H\n"
            "from hydrium_tpu_torch import cli\n"
            "from hydrium_tpu_torch.utils.pfm import write_pfm\n"
            "img = np.random.default_rng(0).integers(0, 256, (300, 520, 3),"
            " dtype=np.uint8)\n"
            "for shift in (-1, 0):\n"
            "    b = H.encode_image(img, shift, profile='conformance')\n"
            "    assert b[:2] == b'\\xff\\x0a', b[:2]\n"
            "write_pfm(sys.argv[1], (img / 255.0).astype(np.float32))\n"
            "assert cli.main([sys.argv[1], sys.argv[2], '--backend', 'numpy',"
            " '--tile-size=0']) == 0\n"
            "assert open(sys.argv[2], 'rb').read(2) == b'\\xff\\x0a'\n"
            "assert not torch.cuda.is_initialized()\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('hydrium_tpu', 'jax', "
            "'jaxlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO),
               HYDRIUM_TORCH_WARM_CACHE=str(tmp_path / "warm.npz"))
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "in.pfm"), str(tmp_path / "o.jxl")],
                         cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    assert not (tmp_path / "warm.npz").exists()


def test_tables_equal_the_jax_package():
    names = [n for n in dir(tables)
             if n.isupper() and isinstance(getattr(tables, n),
                                           (np.ndarray, int))]
    assert len(names) >= 10
    for n in names:
        np.testing.assert_array_equal(getattr(tables, n),
                                      getattr(jax_tables, n), err_msg=n)
        assert np.asarray(getattr(tables, n)).dtype == \
            np.asarray(getattr(jax_tables, n)).dtype, n


@pytest.mark.parametrize("num_presets", [1, 2, 28, 29, 85, 86, 128, 256])
def test_hf_cluster_maps_equal_the_jax_package(num_presets):
    got = tables.hf_cluster_map(num_presets)
    want = jax_tables.hf_cluster_map(num_presets)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_token_codec_equals_the_jax_package():
    """The generic prior's tables, and the tables after one histogram
    update: lengths, codewords and decode LUTs."""
    mine, ref = tokcode.TokenCodec(), jax_tokcode.TokenCodec()
    for k in ("ALPHABET", "LF_CLASS", "NROWS", "MAX_LEN", "LUT_BITS"):
        assert getattr(tokcode, k) == getattr(jax_tokcode, k), k
    hist = np.random.default_rng(5).integers(0, 5000, (10, 64))
    for step in range(2):
        for a, b in zip(mine.tables(), ref.tables()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        mine.update(hist)
        ref.update(hist)
