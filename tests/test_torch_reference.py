"""The port's copies of the numpy conformance plane (ops/reference.py,
ops/hf_tokens.py, models/profiles.py) against the JAX package's
originals on seeded inputs.  Both sides are numpy, so every comparison
is exact: integer and float arrays alike with assert_array_equal."""

import numpy as np
import pytest

from hydrium_tpu import models as jax_models
from hydrium_tpu.ops import hf_tokens as jax_tok
from hydrium_tpu.ops import reference as jax_ref
from hydrium_tpu.ops import tables as jax_tables
from hydrium_tpu_torch import models
from hydrium_tpu_torch.ops import hf_tokens as tok
from hydrium_tpu_torch.ops import reference as ref
from hydrium_tpu_torch.ops import tables

eq = np.testing.assert_array_equal


def _floats(seed, shape):
    """Seeded float32 samples in [0, 1] with the edges and the sRGB
    knee (0.0404482362771082) among them."""
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    flat = x.reshape(-1)
    flat[:5] = [0.0, 1.0, 0.0404482362771082, 0.04044824, 0.5]
    return x


@pytest.mark.parametrize("name", ["linearize", "fast_cbrtf", "bias_func",
                                  "f32_to_u16"])
def test_scalar_functions_equal_the_jax_package(name):
    x = _floats(1, (4096,))
    eq(getattr(ref, name)(x), getattr(jax_ref, name)(x))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("need_linearize", [True, False])
def test_input_lut_equals_the_jax_package(bits, need_linearize):
    got = ref.input_lut(bits, need_linearize)
    assert got.dtype == np.uint16 and got.shape == (1 << bits,)
    eq(got, jax_ref.input_lut(bits, need_linearize))


def test_bias_lut_equals_the_jax_package():
    eq(ref.bias_lut(), jax_ref.bias_lut())


def test_rgb_to_xyb_int_equals_the_jax_package():
    rgb = np.random.default_rng(2).integers(0, 65536, (33, 17, 3),
                                            dtype=np.uint16)
    rgb[0, 0] = 65535
    eq(ref.rgb_to_xyb_int(rgb), jax_ref.rgb_to_xyb_int(rgb))


@pytest.mark.parametrize("need_linearize", [True, False])
def test_rgb_to_xyb_float_equals_the_jax_package(need_linearize):
    rgb = _floats(3, (21, 13, 3))
    eq(ref.rgb_to_xyb_float(rgb, need_linearize),
       jax_ref.rgb_to_xyb_float(rgb, need_linearize))


def test_rgb_to_xyb_float_rejects_nan_as_the_jax_package_does():
    rgb = _floats(4, (2, 2, 3))
    rgb[1, 1, 2] = np.nan
    for f in (ref.rgb_to_xyb_float, jax_ref.rgb_to_xyb_float):
        with pytest.raises(ValueError, match="Invalid NaN Float"):
            f(rgb, True)


def _pixels(fmt, shape, seed):
    rng = np.random.default_rng(seed)
    if fmt == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if fmt == "uint16":
        return rng.integers(0, 65536, shape, dtype=np.uint16)
    return _floats(seed, shape)


@pytest.mark.parametrize("fmt", ["uint8", "uint16", "float32"])
@pytest.mark.parametrize("linear_light", [False, True])
def test_pixels_to_xyb_equals_the_jax_package(fmt, linear_light):
    px = _pixels(fmt, (19, 27, 3), 5)
    got = ref.pixels_to_xyb(px, fmt, linear_light)
    assert got.dtype == np.float32 and got.shape == px.shape
    eq(got, jax_ref.pixels_to_xyb(px, fmt, linear_light))


def test_pixels_to_xyb_rejects_an_unknown_format():
    with pytest.raises(ValueError, match="Invalid Sample Format"):
        ref.pixels_to_xyb(np.zeros((1, 1, 3), np.uint8), "int8", False)


@pytest.mark.parametrize("h,w", [(1, 1), (17, 33), (9, 250), (64, 40)])
def test_dct_and_quantization_chain_equals_the_jax_package(h, w):
    """pad_to_blocks -> forward_dct -> zigzag_gather -> quantize_hf /
    quantize_lf on padded odd sizes, each stage held on its own."""
    xyb = jax_ref.pixels_to_xyb(_pixels("uint8", (h, w, 3), h * w), "uint8",
                                False)
    pad = ref.pad_to_blocks(xyb, h, w)
    eq(pad, jax_ref.pad_to_blocks(xyb, h, w))
    assert pad.shape == (((h + 7) >> 3) * 8, ((w + 7) >> 3) * 8, 3)
    coeffs = ref.forward_dct(pad)
    eq(coeffs, jax_ref.forward_dct(pad))
    zz = ref.zigzag_gather(coeffs)
    eq(zz, jax_ref.zigzag_gather(coeffs))
    (q, nz), (jq, jnz) = ref.quantize_hf(zz), jax_ref.quantize_hf(zz)
    eq(q, jq)
    eq(nz, jnz)
    assert q.dtype == nz.dtype == np.int32
    lf = ref.quantize_lf(coeffs[:, :, 0, 0, :])
    eq(lf, jax_ref.quantize_lf(coeffs[:, :, 0, 0, :]))
    eq(ref.lf_predict_residuals(lf), jax_ref.lf_predict_residuals(lf))


def test_pack_signed_equals_the_jax_package():
    v = np.random.default_rng(6).integers(-(1 << 20), 1 << 20, 4096)
    eq(ref.pack_signed(v), jax_ref.pack_signed(v))


def test_hybridize_and_clz_equal_the_jax_package():
    sym = np.random.default_rng(7).integers(0, 1 << 31, 4096,
                                            dtype=np.uint32)
    sym[:40] = np.arange(40)
    sym[40] = 0xFFFFFFFF
    for a, b in zip(tok.hybridize_u32(sym), jax_tok.hybridize_u32(sym)):
        assert a.dtype == b.dtype
        eq(a, b)
    eq(tok._clz32(sym), jax_tok._clz32(sym))


def test_nonzero_prediction_and_context_equal_the_jax_package():
    nz = np.random.default_rng(8).integers(0, 64, (32, 29, 3))
    pred = tok.predicted_nonzeroes(nz)
    eq(pred, jax_tok.predicted_nonzeroes(nz))
    eq(tok.nz_context(pred), jax_tok.nz_context(pred))


def _group(seed, gbh=32, gbw=32):
    """One group's quantized HF coefficients from the plane itself."""
    xyb = jax_ref.pixels_to_xyb(
        _pixels("uint8", (gbh * 8, gbw * 8, 3), seed), "uint8", False)
    return jax_ref.quantize_hf(jax_ref.zigzag_gather(
        jax_ref.forward_dct(xyb)))


@pytest.mark.parametrize("num_presets,preset", [(1, 0), (2, 1)])
def test_tokenize_group_equals_the_jax_package(num_presets, preset):
    q, nz = _group(9, 32, 27)
    cmap = tables.hf_cluster_map(num_presets)
    got = tok.tokenize_group(q, nz, preset, cmap)
    want = jax_tok.tokenize_group(q, nz, preset,
                                  jax_tables.hf_cluster_map(num_presets))
    for field in ("tokens", "clusters", "residues", "residue_bits",
                  "valid_len"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        eq(a, b, err_msg=field)
    assert got.symbol_count == want.symbol_count > 0
    for a, b in zip(got.flatten(), want.flatten()):
        eq(a, b)


def test_profiles_equal_the_jax_package_but_the_device_plane():
    assert models.get_profile("conformance") == models.CONFORMANCE
    assert models.CONFORMANCE.backend == "numpy"
    assert models.FAST.backend == "torch"        # JAX: "jax"
    assert (models.CONFORMANCE.name, models.FAST.name) == (
        jax_models.CONFORMANCE.name, jax_models.FAST.name)
    with pytest.raises(ValueError) as got:
        models.get_profile("turbo")
    with pytest.raises(ValueError) as want:
        jax_models.get_profile("turbo")
    assert str(got.value) == str(want.value)
