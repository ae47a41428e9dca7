"""The port's command line (hydrium_tpu_torch/cli.py) on the CPU: it
writes exactly the bytes of hydrium_tpu_torch.encode_image on the same
array, and, with the port's front replaced by the JAX package's integers
(test_torch_e2e.jax_front), the bytes of hydrium_tpu.cli with --backend
jax on the same file."""

import os

import numpy as np
import pytest
import torch

import hydrium_tpu_torch as H
from hydrium_tpu import cli as jax_cli
from hydrium_tpu_torch import cli
from hydrium_tpu_torch.utils.pfm import write_pfm
from test_e2e import make_image
from test_pngio import _raw_png
from test_torch_e2e import jax_front, warm_state  # noqa: F401 (fixtures)
from test_torch_formats import _minimal_icc


def _write_png(path, arr):
    depth = 16 if arr.dtype == np.uint16 else 8
    path.write_bytes(_raw_png(arr, depth, 2, [0, 1, 2]).read())


@pytest.mark.parametrize("mode,shift", [("--one-frame", -1),
                                        ("--tile-size=0", 0)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_bytes_equal_encode_image_and_the_jax_cli(tmp_path, jax_front,
                                                      mode, shift, dtype):
    arr = make_image(300, 700, "noise", seed=5)
    if dtype == np.uint16:
        arr = arr.astype(np.uint16) * 257 + 3
    png = tmp_path / "in.png"
    _write_png(png, arr)
    out, ref = tmp_path / "out.jxl", tmp_path / "ref.jxl"
    assert cli.main([str(png), str(out), mode, "--device", "cpu"]) == 0
    assert jax_cli.main([str(png), str(ref), mode, "--backend", "jax"]) == 0
    got = out.read_bytes()
    assert got == H.encode_image(arr, shift, device="cpu")
    assert got == ref.read_bytes()


@pytest.mark.parametrize("flags", [["--one-frame"], ["--linear"],
                                   ["--tile-size=1", "--linear"]])
def test_pfm_bytes_equal_encode_image_and_the_jax_cli(tmp_path, jax_front,
                                                      flags):
    img = np.random.default_rng(9).random((300, 300, 3), dtype=np.float32)
    pfm = tmp_path / "t.pfm"
    write_pfm(str(pfm), img)
    out, ref = tmp_path / "t.jxl", tmp_path / "ref.jxl"
    assert cli.main([str(pfm), str(out), "--device", "cpu"] + flags) == 0
    assert jax_cli.main([str(pfm), str(ref), "--backend", "jax"] + flags) == 0
    shift = 1 if "--tile-size=1" in flags else -1
    got = out.read_bytes()
    assert got == H.encode_image(img, shift, linear_light="--linear" in flags,
                                 device="cpu")
    assert got == ref.read_bytes()


@pytest.mark.parametrize("mode,shift", [("--one-frame", -1),
                                        ("--tile-size=0", 0)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_profile_conformance_png_equals_the_jax_cli(tmp_path, monkeypatch,
                                                    mode, shift, dtype):
    """The numpy plane on the default device ("cuda") with no card: the
    JAX CLI's file, and encode_image's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = make_image(300, 700, "smooth", seed=7)
    if dtype == np.uint16:
        arr = arr.astype(np.uint16) * 257 + 3
    png = tmp_path / "in.png"
    _write_png(png, arr)
    out, ref = tmp_path / "out.jxl", tmp_path / "ref.jxl"
    flags = [mode, "--profile", "conformance"]
    assert cli.main([str(png), str(out)] + flags) == 0
    assert jax_cli.main([str(png), str(ref)] + flags) == 0
    got = out.read_bytes()
    assert got == ref.read_bytes()
    assert got == H.encode_image(arr, shift, profile="conformance")


@pytest.mark.parametrize("flags", [["--linear"], ["--tile-size=1", "--linear"],
                                   ["--profile", "fast", "--linear"]])
def test_backend_numpy_pfm_equals_the_jax_cli(tmp_path, flags):
    """--backend numpy overrides --profile, as in the JAX CLI."""
    img = np.random.default_rng(11).random((300, 300, 3), dtype=np.float32)
    pfm = tmp_path / "t.pfm"
    write_pfm(str(pfm), img)
    out, ref = tmp_path / "t.jxl", tmp_path / "ref.jxl"
    argv = ["--backend", "numpy"] + flags
    assert cli.main([str(pfm), str(out), "--device", "cuda"] + argv) == 0
    assert jax_cli.main([str(pfm), str(ref)] + argv) == 0
    shift = 1 if "--tile-size=1" in flags else -1
    got = out.read_bytes()
    assert got == ref.read_bytes()
    assert got == H.encode_image(img, shift, linear_light=True,
                                 backend="numpy")


def test_pfm_flag_overrides_the_suffix(tmp_path):
    img = np.random.default_rng(10).random((40, 50, 3), dtype=np.float32)
    src = tmp_path / "image.bin"
    write_pfm(str(src), img)
    out = tmp_path / "o.jxl"
    assert cli.main([str(src), str(out), "--pfm", "--device", "cpu"]) == 0
    assert out.read_bytes() == H.encode_image(img, device="cpu")


def test_tag_icc_from_round_trip(tmp_path, jax_front):
    arr = make_image(64, 90, "smooth", seed=3)
    png, icc = tmp_path / "in.png", tmp_path / "p.icc"
    _write_png(png, arr)
    icc.write_bytes(_minimal_icc())
    out, ref = tmp_path / "o.jxl", tmp_path / "ref.jxl"
    argv = [str(png), "--tag-icc-from", str(icc)]
    assert cli.main(argv + [str(out), "--device", "cpu"]) == 0
    assert jax_cli.main(argv + [str(ref), "--backend", "jax"]) == 0
    enc = H.Encoder(H.ImageMetadata(width=90, height=64), device="cpu")
    enc.set_suggested_icc_profile(_minimal_icc())
    enc.send_tile(arr, 0, 0)
    got = out.read_bytes()
    assert got == enc.take_output()
    assert got == ref.read_bytes()
    assert got != H.encode_image(arr, device="cpu")


def test_spool_from_four_lf_groups_up(tmp_path, monkeypatch):
    """Four LF groups: the sections spool under a temporary directory
    that is gone when main returns; same bytes as the in-RAM encode."""
    import tempfile

    arr = make_image(40, 6200, "smooth", seed=6)
    png = tmp_path / "wide.png"
    _write_png(png, arr)
    spool = tmp_path / "spool"
    spool.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(spool))
    seen = []
    real = H.Encoder.__init__

    def spy(self, *a, **k):
        seen.append((k.get("spool_dir"), os.listdir(spool)))
        real(self, *a, **k)

    monkeypatch.setattr(H.Encoder, "__init__", spy)
    out = tmp_path / "wide.jxl"
    assert cli.main([str(png), str(out), "--device", "cpu"]) == 0
    (spool_dir, listing), = seen
    assert spool_dir is not None and os.path.basename(spool_dir) in listing
    assert os.listdir(spool) == []
    monkeypatch.setattr(H.Encoder, "__init__", real)
    assert out.read_bytes() == H.encode_image(arr, device="cpu")


def test_stats_and_verify_report(tmp_path, capsys):
    arr = make_image(120, 200, "smooth", seed=2)
    png = tmp_path / "in.png"
    _write_png(png, arr)
    out = tmp_path / "o.jxl"
    assert cli.main([str(png), str(out), "--device", "cpu", "--verify",
                     "--stats"]) == 0
    err = capsys.readouterr().err
    assert "200x120 ->" in err and "lfg_packed" in err
    psnr = float(err.split("PSNR")[1].split()[0])
    assert psnr > 30, err


def test_other_image_formats_fall_back_to_pil(tmp_path):
    from PIL import Image

    arr = make_image(70, 100, "smooth", seed=4)
    bmp = tmp_path / "in.bmp"
    Image.fromarray(arr).save(bmp)
    out = tmp_path / "o.jxl"
    assert cli.main([str(bmp), str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == H.encode_image(arr, device="cpu")


@pytest.mark.parametrize("argv,message", [
    (["--profile", "turbo"], "invalid choice"),
    (["--one-frame", "--tile-size=1"], "incompatible"),
    (["--tile-size=4"], "0-3"),
    (["--tile-size=0", "--tag-icc-from", "x.icc"], "one-frame"),
    (["--backend", "jax"], "invalid choice")])
def test_bad_arguments_exit_non_zero_with_a_message(tmp_path, capsys, argv,
                                                    message):
    png = tmp_path / "in.png"
    _write_png(png, make_image(16, 16, "smooth"))
    out = tmp_path / "o.jxl"
    with pytest.raises(SystemExit) as exc:
        cli.main([str(png), str(out), "--device", "cpu"] + argv)
    assert exc.value.code not in (0, None)
    assert message in capsys.readouterr().err
    assert not out.exists()


def test_default_device_is_the_card_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    png = tmp_path / "in.png"
    _write_png(png, make_image(16, 16, "smooth"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(png), str(tmp_path / "o.jxl")])
