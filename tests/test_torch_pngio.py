"""The port's input readers (hydrium_tpu_torch/utils/pngio.py, pfm.py)
against the JAX package's on the same bytes: equal arrays, dtype
included, with the native defilter (csrc/host/serializer.cc
hyd_png_unfilter) and with the pure-Python one."""

import io

import numpy as np
import pytest

from hydrium_tpu.utils import pfm as jax_pfm
from hydrium_tpu.utils import pngio as jax_pngio
from hydrium_tpu_torch.jxl import native
from hydrium_tpu_torch.utils import pfm, pngio
from test_pngio import _pil_png, _raw_png


def _palette_png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).quantize(64).save(buf, format="PNG")
    buf.seek(0)
    return buf


def _gradient(h, w):
    """Content on which PIL's optimizer picks Paeth and Average."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(yy * 2) % 256, (xx * 3) % 256, (yy + xx) % 256],
                    axis=-1).astype(np.uint8)


def _png_cases():
    rng = np.random.default_rng(31)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    rgb16 = rng.integers(0, 65536, (25, 31, 3), dtype=np.uint16)
    return {
        "rgb8": lambda: _pil_png(rgb),
        "rgba": lambda: _pil_png(rng.integers(0, 256, (40, 50, 4),
                                              dtype=np.uint8)),
        "gray": lambda: _pil_png(rng.integers(0, 256, (40, 50),
                                              dtype=np.uint8)),
        "gray_alpha": lambda: _raw_png(rng.integers(0, 256, (20, 30, 2),
                                                    dtype=np.uint8), 8, 4),
        "palette": lambda: _palette_png(rgb),
        "rgb16": lambda: _raw_png(rgb16, 16, 2),
        "rgb16_sub_up": lambda: _raw_png(rgb16, 16, 2, [1, 2]),
        "filter_none": lambda: _raw_png(rgb, 8, 2, [0]),
        "filter_sub": lambda: _raw_png(rgb, 8, 2, [1]),
        "filter_up": lambda: _raw_png(rgb, 8, 2, [2]),
        "filter_mixed": lambda: _raw_png(rgb, 8, 2, [0, 1, 2]),
        "filter_paeth_average": lambda: _pil_png(_gradient(120, 90)),
    }


CASES = _png_cases()


@pytest.mark.parametrize("defilter", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_png_reader_equals_jax_package(case, defilter, monkeypatch):
    data = CASES[case]().read()
    ref = jax_pngio.PNGReader(io.BytesIO(data))
    want = ref.read_rows(ref.height)
    if defilter == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available()
    r = pngio.PNGReader(io.BytesIO(data))
    assert (r.width, r.height, r.fmt) == (ref.width, ref.height, ref.fmt)
    # strips of 7 rows, as the CLI reads strips
    parts = []
    while len(parts) * 7 < r.height:
        parts.append(r.read_rows(7))
    got = np.concatenate(parts, axis=0)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert r.read_rows(3).shape == (0, r.width, 3)
    assert np.array_equal(pngio.read_png(io.BytesIO(data)), want)


def test_every_filter_type_native_equals_python():
    """One row through each of the five filters, first row and later
    rows, at 3 and 6 bytes per pixel."""
    rng = np.random.default_rng(32)
    for bpp in (3, 6):
        prev = rng.integers(0, 256, 60, dtype=np.uint8)
        for filt in range(5):
            for above in (None, prev):
                row = rng.integers(0, 256, 60, dtype=np.uint8)
                got = row.copy()
                native.png_unfilter(got, above, bpp, filt)
                want = bytearray(row.tobytes())
                pngio._unfilter_py(want, None if above is None
                                   else above.tobytes(), bpp, filt)
                assert got.tobytes() == bytes(want), (bpp, filt)
    with pytest.raises(ValueError):
        native.png_unfilter(prev.copy(), None, 3, 5)
    with pytest.raises(ValueError):
        pngio._unfilter_py(bytearray(6), None, 3, 5)


@pytest.mark.parametrize("bad", ["signature", "interlaced", "depth4"])
def test_png_reader_rejects_what_the_jax_package_rejects(bad):
    rng = np.random.default_rng(33)
    data = bytearray(_raw_png(rng.integers(0, 256, (4, 4, 3),
                                           dtype=np.uint8), 8, 2).read())
    if bad == "signature":
        data[0] = 0
    elif bad == "interlaced":
        data[8 + 8 + 12] = 1        # IHDR's last byte
    else:
        data[8 + 8 + 8] = 4         # bit depth
    for reader in (jax_pngio.PNGReader, pngio.PNGReader):
        with pytest.raises(ValueError):
            reader(io.BytesIO(bytes(data)))


def test_pfm_row_reader_equals_read_pfm_and_the_jax_package(tmp_path):
    rng = np.random.default_rng(34)
    img = rng.random((75, 60, 3), dtype=np.float32)
    p = tmp_path / "t.pfm"
    pfm.write_pfm(str(p), img)
    q = tmp_path / "j.pfm"
    jax_pfm.write_pfm(str(q), img)
    assert p.read_bytes() == q.read_bytes()
    r = pfm.PFMRowReader(str(p))
    assert (r.width, r.height, r.fmt) == (60, 75, "float32")
    got = np.concatenate([r.read_rows(16) for _ in range(5)], axis=0)
    r.close()
    assert got.dtype == np.float32
    assert np.array_equal(got, pfm.read_pfm(str(p)))
    assert np.array_equal(got, jax_pfm.read_pfm(str(p)))
    assert np.array_equal(got, img)
    with open(p, "rb") as f:
        assert np.array_equal(pfm.read_pfm(f), img)


def test_pfm_big_endian_and_errors(tmp_path):
    img = np.random.default_rng(35).random((5, 4, 3), dtype=np.float32)
    p = tmp_path / "be.pfm"
    p.write_bytes(b"PF\n4 5\n1.0\n" + img[::-1].astype(">f4").tobytes())
    assert np.array_equal(pfm.read_pfm(str(p)), img)
    assert np.array_equal(pfm.PFMRowReader(str(p)).read_rows(5), img)
    bad = tmp_path / "bad.pfm"
    bad.write_bytes(b"Pf\n4 5\n1.0\n")
    with pytest.raises(ValueError):
        pfm.read_pfm(str(bad))
    with pytest.raises(ValueError):
        pfm.PFMRowReader(str(bad))
    short = tmp_path / "short.pfm"
    short.write_bytes(b"PF\n4 5\n-1.0\n" + bytes(10))
    with pytest.raises(ValueError):
        pfm.read_pfm(str(short))
