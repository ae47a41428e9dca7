"""The comparison that decides `correct` fails what it must: the TF32
control, and a run with the timed path broken underneath (a token
altered where it is produced; half of each dispatch's rows left out),
and a file broken after the fact."""

import json

import numpy as np
import pytest

from jxlbench import run
from jxlbench.ref.bits import ParseFault
from jxlbench.ref.compare import judge
from jxlbench.ref.control import control_q
from jxlbench.ref.decode import decode
from jxlbench.ref.front import reference_inputs

from .conftest import CELLS, SIZE, full_spec


def _image(seed=11, size=SIZE):
    from jxlbench.content import photo

    params = run.load_json(run.BENCH / "traffic" / "photo4k.json")["params"]
    params = dict(params, height=size[0], width=size[1])
    return photo.make(params, seed, 1, "cpu")[0]


def _limit(cell):
    return run.resolve(full_spec(), cell)[1]["limits"]["margin_max"]


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(cell):
    img = _image(size=(512, 768))
    u_lf, u_hf = reference_inputs(img)
    q_lf, q_hf = control_q(img, "cpu")
    assert judge(u_lf, u_hf, q_lf, q_hf)["margin_max"] > _limit(cell)


def _alter_token(orig):
    """The first coefficient token of a block that codes a nonzero value
    with no residue bits (4..11) moves by 4: a nonzero value it stays, so
    the stream stays well formed and only the value is wrong.  Where no
    block has one (a smooth image's HF is all but empty), the first LF
    residual token moves by 4 instead: the file stays well formed and a
    DC value is wrong."""
    def front_tokens(*a, **kw):
        out = orig(*a, **kw)
        tok, vl = out["tokens"], out["valid_len"]
        rows = ((vl >= 2) & (tok[:, 1] >= 4) & (tok[:, 1] < 12)).nonzero()
        if rows.numel():
            r = int(rows[0])
            tok = tok.clone()
            tok[r, 1] += 4
            out["tokens"] = tok
        else:
            res = out["lf_res"].clone()
            res.view(-1)[0] += 4
            out["lf_res"] = res
        return out
    return front_tokens


def _drop_half(orig):
    def front_tokens(front, pixels, height, *a, **kw):
        pixels = pixels.clone()
        pixels[height // 2:] = 0
        return orig(front, pixels, height, *a, **kw)
    return front_tokens


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_alter_token, _drop_half])
def test_broken_timed_path_is_not_correct(tiny_run, monkeypatch, cell,
                                          fault):
    from hydrium_tpu_torch.ops import front

    monkeypatch.setattr(front, "front_tokens", fault(front.front_tokens))
    line = tiny_run(cell)
    json.dumps(line)
    assert line["correct"] is False
    assert line["failed"] >= 1


def _sound_file():
    import hydrium_tpu_torch as H

    img = _image(seed=12)
    return img, H.encode_image(img, -1, device="cpu")


def test_sound_file_passes():
    img, data = _sound_file()
    c = decode(data)
    u_lf, u_hf = reference_inputs(img)
    assert judge(u_lf, u_hf, c.lf, c.hf)["margin_max"] < _limit(
        "oneframe.photo4k")


@pytest.mark.parametrize("cut", ["truncate", "append", "flip"])
def test_broken_file_is_a_parse_fault_or_wrong(cut):
    img, data = _sound_file()
    if cut == "truncate":
        data = data[:-3]
    elif cut == "append":
        data = data + b"\0"
    else:
        b = bytearray(data)
        b[len(b) // 2] ^= 0x10
        data = bytes(b)
    try:
        c = decode(data)
    except ParseFault:
        return
    u_lf, u_hf = reference_inputs(img)
    assert judge(u_lf, u_hf, c.lf, c.hf)["margin_max"] > _limit(
        "oneframe.photo4k")


def test_every_distinct_file_is_judged():
    """Ten distinct files, one of them broken: every file is judged, so
    the broken one is found however many there are."""
    import hashlib

    import hydrium_tpu_torch as H

    from jxlbench import check

    imgs = np.stack([_image(seed=30 + k, size=(64, 64)) for k in range(9)])
    files, uses = {}, {}
    for k, img in enumerate(imgs):
        data = H.encode_image(img, -1, device="cpu")
        files[k] = {hashlib.sha256(data).hexdigest(): data}
        uses[k] = {key: 2 for key in files[k]}
    bad = data[:-3]
    files[8][hashlib.sha256(bad).hexdigest()] = bad
    uses[8][hashlib.sha256(bad).hexdigest()] = 1
    cfg = run.resolve(full_spec(), "oneframe.photo4k")[1]
    v = check.judge_window(imgs, files, uses, cfg, workers=2)
    assert v["files"] == 10
    assert v["checks"]["parse_faults"]["value"] == 1
    assert v["failed"] == 1


@pytest.mark.cuda
def test_tf32_control_on_card_is_not_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    img = _image(size=(1024, 1536))
    u_lf, u_hf = reference_inputs(img)
    q_lf, q_hf = control_q(img, "cuda")
    assert judge(u_lf, u_hf, q_lf, q_hf)["margin_max"] > _limit(
        "oneframe.photo4k")
    np.testing.assert_array_equal(q_lf, control_q(img, "cuda")[0])
