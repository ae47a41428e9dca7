"""The port's bench (hydrium_tpu_torch/bench.py) on the CPU: its fixtures
equal the root bench.py's, its encodes equal the JAX package's
backend="jax" with the front patched, its device plane's payload words
equal JAX encode_lfg_packed's, and its command line prints every key
on the CPU and refuses a missing card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as jax_bench
from hydrium_tpu import encode_image as jax_encode_image
from hydrium_tpu.jxl.tokcode import TokenCodec as JaxTokenCodec
from hydrium_tpu.ops import pipeline as P
from hydrium_tpu.ops import tables as jax_tables
from hydrium_tpu_torch import bench
from test_torch_e2e import REPO, jax_front, warm_state  # noqa: F401

VARIANT_KEYS = ("ms_per_lfg", "mpix_s", "per_call_ms", "queued_ms_per_lfg")


@pytest.mark.parametrize("name", ["make_4k_noisy", "make_4k_smooth",
                                  "make_4k_photo"])
def test_fixture_equals_root_bench(name):
    mine, theirs = getattr(bench, name)(), getattr(jax_bench, name)()
    assert mine.dtype == theirs.dtype == np.uint8
    assert mine.shape == theirs.shape == (2160, 3840, 3)
    assert mine.tobytes() == theirs.tobytes()


@pytest.mark.parametrize("shift", [-1, 0])
def test_measure_bytes_equal_jax_backend(jax_front, shift):
    """The slice as a whole: _measure's file of a 512x384 crop of the
    noisy fixture, one-frame and tiled, is backend="jax"'s."""
    crop = np.ascontiguousarray(bench.make_4k_noisy()[:512, :384])
    fig, data = bench._measure(crop, 2, "test", shift, "cpu")
    assert data == jax_encode_image(crop, tile_size_shift=shift,
                                    backend="jax")
    assert fig["mpix_s"] >= fig["median_mpix_s"] > 0
    assert len(fig["walls_s"]) == 2 and fig["spread"] >= 0
    # the upload of every pixel at least, and the payload back
    assert fig["wire_bpp"] > 24
    assert fig["idle_share"] is None        # no device on the CPU


def test_device_plane_reports_every_key_on_cpu():
    out = bench.device_plane(1, "cpu", (256, 256))
    for v in ("torch", "fused", "unpacked"):
        for k in VARIANT_KEYS:
            assert out[f"{v}_{k}"] > 0, (v, k)
    assert out["device"] == "cpu" and out["card"] is None
    # the CPU runs the kernels' plain twins: no launch
    assert set(out["fused_launches_per_call"]) == set(bench.KERNELS)
    assert not any(out["fused_launches_per_call"].values())
    assert len(out["fused_top_ops"]) == 5
    assert all(op["ms_per_call"] > 0 for op in out["fused_top_ops"])
    json.dumps(out)


@pytest.mark.parametrize("variant", ["torch", "fused", "unpacked"])
def test_device_plane_equals_jax_pipeline(jax_front, variant):
    """The device plane's calls on a 256x256 LF group, the front patched
    to JAX's integers: the packed variants' combined words equal JAX
    encode_lfg_packed's, the unpacked variant's histogram JAX
    encode_lfg's."""
    got = bench.plane_variants("cpu", (256, 256))[variant]()
    px = jnp.asarray(bench.make_4k_noisy()[:256, :256])
    args = (px, 256, 256, jnp.zeros(1, jnp.int32),
            jnp.asarray(jax_tables.hf_cluster_map(1)))
    kw = dict(buf_h=256, buf_w=256, linear_light=False, num_clusters=9,
              sample_kind="uint8")
    if variant == "unpacked":
        want = P.encode_lfg(*args, **kw)
        np.testing.assert_array_equal(got["hist"].numpy(),
                                      np.asarray(want["hist"]))
        np.testing.assert_array_equal(got["valid_len"].numpy(),
                                      np.asarray(want["valid_len"]))
        return
    lens, codes, _ = JaxTokenCodec().tables()
    want = np.asarray(P.encode_lfg_packed(
        *args, jnp.asarray(lens.astype(np.int32)),
        jnp.asarray(codes.astype(np.int32)), tok_classes=9, **kw)["combined"])
    assert want[0] == 1
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("text,want", [("256x384", (256, 384)),
                                       ("2048X2048", (2048, 2048))])
def test_parse_crop(text, want):
    assert bench.parse_crop(text) == want


@pytest.mark.parametrize("text", ["256", "0x4", "ax3", "1x2x3"])
def test_parse_crop_refuses(text):
    with pytest.raises(Exception, match="crop"):
        bench.parse_crop(text)


def test_device_plane_refuses_a_crop_beyond_an_lf_group():
    with pytest.raises(ValueError, match="2048x2048"):
        bench.plane_variants("cpu", (2049, 16))


def _run(args, tmp_path, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HOME=str(tmp_path),
               HYDRIUM_TORCH_WARM_CACHE=str(tmp_path / "warm.npz"))
    return subprocess.run([sys.executable, "-m", "hydrium_tpu_torch.bench",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_command_line_on_cpu_prints_every_key(tmp_path):
    res = _run(["1", "--device", "cpu", "--crop", "256x384"], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(l) for l in res.stdout.splitlines()
             if l.startswith("{")]
    assert len(lines) == len(bench.ROWS)    # one cumulative line a row
    last = lines[-1]
    assert last["crop"] == "256x384" and last["iters"] == 1
    assert last["device"] == "cpu" and last["card"] is None
    for n, row in enumerate(bench.ROWS):
        keys = bench.row_keys(row)
        assert set(keys.values()) <= set(last), row
        # the rows run in order, each line adding its row's keys
        assert set(keys.values()) <= set(lines[n]), row
        assert last[keys["mpix_s"]] > 0 and last[keys["median_mpix_s"]] > 0
    assert bench.row_keys("value")["mpix_s"] == "value"
    assert bench.row_keys("value")["wire_bpp"] == "wire_bpp"
    assert bench.row_keys("photo")["wire_bpp"] == "photo_wire_bpp"
    assert "bench[tiled_fused]: stage breakdown" in res.stderr
    # the run's warm state went to a directory of its own
    assert not (tmp_path / "warm.npz").exists()
    assert not (tmp_path / ".cache").exists()


def test_command_line_refuses_cuda_without_a_card(tmp_path):
    assert not torch.cuda.is_available()
    res = _run(["1", "--device", "cuda"], tmp_path, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not any(l.startswith("{") for l in res.stdout.splitlines())
