"""The readers of the program's host-path spans and counters, on
hand-made windows: silent where the program lacks them, exact where it
has them."""

import pytest

from jxlbench import run
from jxlbench.loop import ImageRecord, Window

READERS = ("codec_tables_ms", "codec_rebuild_share", "payload_parse_ms",
           "drain_wait_ms")


def _reading(stages, counters):
    images = [ImageRecord(0.4, 100, 8_294_400, dict(s), dict(c))
              for s, c in zip(stages, counters)]
    win = Window(seconds=0.8, images=images, files={}, uses={})
    return run.Reading(win, None, {}, None)


def _read(name, r):
    return run.load_module(run.BENCH / "metrics" / f"{name}.py").read(r)


PARENT = _reading(
    [{"prepare": 0.09, "walk": 0.2, "fetch_wait": 0.25}] * 2,
    [{"h2d_raw_bytes": 1, "fetched_words": 2, "lfg_packed": 4}] * 2)


@pytest.mark.parametrize("name", READERS)
def test_silent_on_the_parents_window(name):
    assert _read(name, PARENT) is None


@pytest.mark.parametrize("name", READERS)
def test_silent_on_an_empty_window(name):
    assert _read(name, _reading([], [])) is None


# two images, 5 dispatches (2 and 3), 3 of which built the tables
WINDOW = _reading(
    [{"codec_tables": 0.020, "parse": 0.004, "drain_wait": 0.030,
      "prepare": 0.09},
     {"codec_tables": 0.030, "parse": 0.006, "drain_wait": 0.010,
      "prepare": 0.08}],
    [{"dispatches": 2, "codec_table_builds": 1},
     {"dispatches": 3, "codec_table_builds": 2}])


@pytest.mark.parametrize("name,value", [
    ("codec_tables_ms", 1e3 * 0.050 / 5),
    ("codec_rebuild_share", 100.0 * 3 / 5),
    ("payload_parse_ms", 1e3 * 0.010 / 2),
    ("drain_wait_ms", 1e3 * 0.040 / 2)])
def test_value_on_a_hand_made_window(name, value):
    assert _read(name, WINDOW) == pytest.approx(value)


def test_no_builds_is_a_share_of_zero():
    r = _reading([{"codec_tables": 0.001}], [{"dispatches": 4}])
    assert _read("codec_rebuild_share", r) == 0.0
    assert _read("codec_tables_ms", r) == pytest.approx(0.25)


def test_each_reader_has_its_entry():
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["moves"] == "mpix_s"
        assert m["workloads"] == ["oneframe.photo4k"]
