"""The port's profiler hook, utils/stats.py::device_trace (twin of the
JAX package's jax.profiler wrapper), on the CPU."""

import json

import numpy as np
import pytest

import hydrium_tpu_torch
from hydrium_tpu_torch.utils.stats import device_trace
from test_e2e import make_image
from test_torch_e2e import warm_state  # noqa: F401 (autouse fixture)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """A small encode inside the trace: one Chrome trace file under
    log_dir, holding the encode's torch operators."""
    img = make_image(64, 300, "noise", seed=4)
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)) as path:
        data = hydrium_tpu_torch.encode_image(img, device="cpu")
    assert data[:2] == b"\xff\x0a"
    files = sorted(p.name for p in log_dir.iterdir())
    assert files == [path.split("/")[-1]] and files[0].endswith(".json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    with device_trace(str(log_dir)) as second:
        np.zeros(1)
    assert second != path and len(list(log_dir.iterdir())) == 2


@pytest.mark.parametrize("log_dir", [None, ""])
def test_device_trace_is_a_no_op_without_a_directory(log_dir, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    with device_trace(log_dir) as path:
        pass
    assert path is None
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("shift", [-1, 0])
def test_link_byte_counters(shift, monkeypatch):
    """h2d_raw_bytes covers every pixel uploaded, fetched_words at least
    the stream words each payload said it needed, one-frame and tiled."""
    from hydrium_tpu_torch import EncodeStats
    from hydrium_tpu_torch import host

    needed = []
    real = host.packed_need_words

    def spy(aux):
        needed.append(real(aux))
        return needed[-1]

    monkeypatch.setattr(host, "packed_need_words", spy)
    h, w = 300, 520
    img = make_image(h, w, "noise", seed=9)
    stats = EncodeStats()
    data = hydrium_tpu_torch.encode_image(img, shift, device="cpu",
                                          stats=stats)
    assert data[:2] == b"\xff\x0a"
    c = stats.counters
    assert c["lfg_packed"] == len(needed) > 0
    assert c["h2d_raw_bytes"] >= h * w * 3
    assert c["fetched_words"] >= sum(needed) + len(needed)
