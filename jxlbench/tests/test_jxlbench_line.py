"""A tiny run of each cell on the CPU gives the contract's result line;
without a card the entry point exits non-zero and prints no result."""

import json

import pytest

from jxlbench import run

from .conftest import CELLS, bench_cells


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_prints_the_contract_line(tiny_run, cell, trace):
    line = tiny_run(cell, trace)
    json.dumps(line)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["checks"]) == {"parse_faults", "margin_max"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    assert line["device"]["platform"] == "cpu"
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    for k, m in line["metrics"].items():
        assert m["unit"] == units[k] and m["value"] == m["value"]
    if not trace:
        # the device's memory is a card's reading: none on the CPU
        assert set(line["metrics"]) == {"mpix_s", "file_bpp", "setup_s"}
        assert line["metrics"]["file_bpp"]["value"] > 0
    else:
        assert {"prepare_ms", "fetch_wait_ms", "host_entropy_ms",
                "wire_bpp"} <= set(line["metrics"])
        # no card, no trace of one: no device metric from a CPU run
        assert not any(k.endswith("_roofline") or k == "device_idle_share"
                       for k in line["metrics"])


def test_no_card_exits_nonzero_without_a_line(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", bench_cells()[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_module_gives_no_line(tiny_run, monkeypatch):
    import types

    monkeypatch.setitem(__import__("sys").modules, "jax",
                        types.ModuleType("jax"))
    assert tiny_run(bench_cells()[0]) is None


def test_same_seed_same_images():
    from jxlbench.content import photo

    params = run.load_json(run.BENCH / "traffic" / "photo4k.json")["params"]
    params = dict(params, height=64, width=96)
    a = photo.make(params, 2**33 + 5, 2, "cpu")
    b = photo.make(params, 2**33 + 5, 2, "cpu")
    c = photo.make(params, 2**33 + 6, 2, "cpu")
    assert a.shape == (2, 64, 96, 3) and (a == b).all()
    assert not (a == c).all() and not (a[0] == a[1]).all()
