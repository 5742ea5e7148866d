"""The window's rate and block log on made-up blocks, and the spread
script's arithmetic."""
import statistics

import pytest

from benchmark import harness, spread


class FakeRun:
    """Blocks of ``steps`` env steps whose walls are ``walls``, on a clock
    the test owns."""

    def __init__(self, walls, steps=100):
        self.walls, self.steps, self.flops, self.now, self.i = list(walls), steps, 0.0, 0.0, 0

    def clock(self):
        return self.now

    def block(self):
        self.now += self.walls[self.i]
        self.i += 1
        self.flops += 10.0
        return self.steps, {"train/num_updates": float(self.i)}


def test_rate_is_every_step_over_the_whole_window(monkeypatch):
    """A slow block counts in full: the rate is the window's steps over its
    wall, not a block's steps over the median block."""
    run = FakeRun([1.0, 1.0, 4.0, 1.0, 1.0])
    monkeypatch.setattr(harness.time, "perf_counter", run.clock)
    win = harness.window(run, 7.5)
    assert win["blocks"] == 5 and win["steps"] == 500 and win["wall_s"] == 8.0
    # the median block would say 100
    assert harness.metric_reader("env_steps_per_s.window")(win) == 62.5
    assert [b[0] for b in win["block_log"]] == run.walls
    assert [b[1] for b in win["block_log"]] == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert all(len(b) == 2 for b in win["block_log"])
    assert win["model_flops"] == 50.0


# ---------------------------------------------------------------------------
# the spread script
# ---------------------------------------------------------------------------
def test_quartile_spread_is_statistics_quantiles_over_the_median():
    v = [100.0, 104.0, 98.0, 110.0, 101.0, 99.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert spread.quartile_spread(v) == (q3 - q1) / statistics.median(v)
    assert spread.spread_without_farthest(v) == spread.quartile_spread(
        [100.0, 104.0, 98.0, 101.0, 99.0])
    assert spread.quartile_spread([5.0]) == 0.0


def test_block_reading_places_the_slow_blocks():
    blocks = [[1.0, 2], [1.0, 4], [2.0, 6], [1.0, 8], [1.0, 10]]
    r = spread.block_reading(blocks)
    assert r["median_s"] == 1.0 and r["mean_over_median"] == 1.2 and r["slow"] == [2]
    assert r["blocks"] == 5 and r["mean_s"] == 1.2


def test_summary_reads_each_set_apart():
    def rec(set_, rate, walls):
        return {"root": ".", "set": set_, "seed": 1, "result": {
            "correct": True, "metrics": {"env_steps_per_s": {"value": rate, "unit": "x"}},
            "blocks": [[w, 0] for w in walls]}}

    s = spread.summarize([rec(0, 100.0, [1, 1, 2]), rec(0, 90.0, [1, 1, 1]),
                          rec(1, 80.0, [1, 1, 1]), {"root": ".", "set": 1, "seed": 2,
                                                     "result": None}])
    assert s["."]["0"]["env_steps_per_s"]["values"] == [100.0, 90.0]
    assert s["."]["0"]["blocks_per_s"]["values"] == pytest.approx([0.75, 1.0])
    assert s["."]["0"]["blocks_per_s.median"]["values"] == [1.0, 1.0]
    assert s["."]["1"]["blocks_per_s"]["spread"] == 0.0
    assert s["."]["1"]["runs"][1] == {"seed": 2, "no_result": True}
    # the larger set's spread, and the mean of the sets' spreads less far
    set0 = s["."]["0"]["env_steps_per_s"]["spread"]
    assert set0 > 0 and s["."]["larger_spread"]["env_steps_per_s"] == set0
    assert s["."]["tightness"]["env_steps_per_s"] == set0 / 2
