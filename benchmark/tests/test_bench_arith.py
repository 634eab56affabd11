import statistics

import pytest

from benchmark import poses, timing


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert timing.percentile(xs, 99) == 99
    assert timing.percentile(xs, 100) == 100
    assert timing.percentile([5.0], 99) == 5.0
    assert timing.percentile(list(range(1000)), 99) == 989
    with pytest.raises(ValueError):
        timing.percentile([], 50)


def test_rate_and_spread():
    assert timing.rate(300, 1.5) == 200.0
    with pytest.raises(ValueError):
        timing.rate(1, 0.0)
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert timing.spread(vals) == pytest.approx((q3 - q1) / q2)


def test_busy_union_and_idle_gaps():
    busy, merged = timing.busy_intervals([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert busy == 5
    assert merged == [(0, 3), (5, 7)]
    assert timing.idle_gaps(merged, -1, 10) == [(-1, 0), (3, 5), (7, 10)]
    assert timing.busy_intervals([]) == (0.0, [])


def test_latency_from_event_times():
    """A frame's latency is its completion minus its issue; fps is every
    frame over the time to the last completion."""
    issue = [0.000, 0.001, 0.002, 0.010]
    done = [0.004, 0.006, 0.008, 0.030]
    lat = [(d - i) * 1e3 for d, i in zip(done, issue)]
    assert timing.percentile(lat, 99) == pytest.approx(20.0)
    assert timing.rate(len(done), max(done)) == pytest.approx(4 / 0.030)


@pytest.mark.parametrize("mix", ["pan", "stream"])
def test_poses_depend_on_seed_and_index_only(mix):
    from benchmark import spec

    params = spec.traffic(mix)
    a, b = poses.Traffic(params, 2 ** 31 + 5), poses.Traffic(params,
                                                              2 ** 31 + 5)
    assert [a.pose(i) for i in (0, 1, 777)] == [b.pose(i)
                                               for i in (0, 1, 777)]
    c = poses.Traffic(params, 2 ** 31 + 6)
    assert a.pose(10) != c.pose(10)
    p0, p1 = a.pose(0), a.pose(1)
    assert p1.yaw - p0.yaw == pytest.approx(params["yaw_step"])
    moved = [y - x for x, y in zip(p0.position, p1.position)]
    assert moved == pytest.approx(params["move"])


def test_keys_and_jitter_depend_on_seed_and_index_only():
    """A mix of key poses with jitter: the same seed gives the same poses,
    every pose is a key's within the jitter's widths, and the seed picks
    the key the run starts at."""
    keys = [[0, 10, 20, 0.0, -0.1], [64, 30, -64, 1.0, -0.2],
            [-96, 24, 0, 2.0, 0.0]]
    params = dict(keys=keys, frames_per_key=3,
                  jitter=dict(position=0.5, yaw=0.01, pitch=0.002))
    a, b = poses.Traffic(params, 2 ** 33 + 1), poses.Traffic(params,
                                                             2 ** 33 + 1)
    assert [a.pose(i) for i in range(20)] == [b.pose(i) for i in range(20)]
    assert a.moves
    starts = set()
    for seed in range(12):
        t = poses.Traffic(params, seed)
        starts.add(t.key0)
        for i in (0, 2, 3, 5000):
            p = t.pose(i)
            k = keys[(t.key0 + i // 3) % 3]
            assert max(abs(x - y) for x, y in zip(p.position, k[:3])) <= 0.5
            assert abs(p.yaw - k[3]) <= 0.01
            assert abs(p.pitch - k[4]) <= 0.002
    assert len(starts) > 1


def test_unknown_traffic_parameters_raise():
    with pytest.raises(ValueError):
        poses.Traffic(dict(start=[0, 0, 0], pitch=0.0, seed_offset=3), 1)
    with pytest.raises(ValueError):
        poses.Traffic(dict(start=[0, 0, 0], pitch=0.0, loop="open"), 1)
