"""A configuration is run as it states or not at all: a sample format the
harness cannot drive or the reference cannot judge, or a precision it
does not know, is refused rather than run as 8-bit float32."""

import json

import numpy as np
import pytest
import torch

from jxlbench import check, run
from jxlbench.loop import Loop


def _config(**kw):
    cfg = run.load_json(run.BENCH / "configs" / "u8_oneframe.json")
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("key,value", [("sample_format", "uint16"),
                                       ("sample_format", "float32"),
                                       ("precision", "bfloat16 front")])
def test_a_setting_the_harness_cannot_run_is_refused(key, value):
    with pytest.raises(ValueError, match=key):
        Loop(_config(**{key: value}), "cpu")


def test_the_reference_refuses_a_format_it_cannot_judge():
    images = np.zeros((1, 8, 8, 3), np.uint16)
    with pytest.raises(ValueError, match="uint16"):
        check.judge_window(images, {0: {}}, {0: {}},
                           _config(sample_format="uint16"))
    with pytest.raises(ValueError, match="uint16"):
        check.judge_window(images, {0: {}}, {0: {}}, _config())


def test_tf32_on_departs_from_the_configuration(monkeypatch):
    loop = Loop(_config(), "cpu")
    # as the encoder's device resolution leaves them
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    loop.assert_precision()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        loop.assert_precision()


def test_a_configuration_file_states_what_the_loop_reads():
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    for entry in spec["configs"]:
        cfg = json.loads((run.ROOT / entry["file"]).read_text())
        Loop(cfg, "cpu")
