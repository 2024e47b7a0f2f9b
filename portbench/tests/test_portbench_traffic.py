"""The traffic generator: mixes, Zipf, the failed-node rules, the open
loop's schedule and the loss order."""

import numpy as np
import pytest

from portbench import traffic


@pytest.mark.parametrize("mix,n,puts", [({"get": 0.95, "put": 0.05}, 1000, 50),
                                        ({"get": 0.5, "put": 0.5}, 999, 499),
                                        ({"get": 1.0}, 10, 0)])
def test_exact_mix(mix, n, puts):
    kinds = traffic.kinds_exact(mix, n, np.random.default_rng(0))
    assert len(kinds) == n and kinds.count("put") == puts


def test_zipf_probs():
    p = traffic.zipf_probs(600, 0.99)
    assert abs(p.sum() - 1) < 1e-12 and np.all(np.diff(p) < 0)
    assert p[0] / p[1] == pytest.approx(2 ** 0.99)


def test_key_chooser_favours_the_first_ranks():
    order = traffic.ranked(list(range(100, 200)), set(), np.random.default_rng(7))
    assert sorted(order) == list(range(100, 200))
    a = traffic.KeyChooser(order, 0.99, np.random.default_rng(7)).draw(5000)
    assert a == traffic.KeyChooser(order, 0.99, np.random.default_rng(7)).draw(5000)
    assert max(set(a), key=a.count) == order[0] and a.count(order[0]) > 5000 * 0.1


def test_spread_keys_take_the_same_ranks_for_every_seed():
    keys, spread = list(range(600)), set(range(0, 600, 9))
    share = []
    for seed in range(4):
        order = traffic.ranked(keys, spread, np.random.default_rng(seed))
        assert sorted(order) == keys
        ranks = [r for r, key in enumerate(order) if key in spread]
        assert ranks == [int((i + 0.5) * 600 / len(spread)) for i in range(len(spread))]
        share.append(traffic.zipf_probs(600, 0.99)[ranks].sum())
    assert max(share) == min(share) and 0.08 < share[0] < 0.12


def test_crash_most_data_blocks_lowest_id_wins_ties():
    # rows 0..1 hold data (t = 2), row 2 parity; k = 2 of n = 3 columns
    placement = {("g0", 0, 0): 5, ("g0", 0, 1): 3, ("g0", 1, 0): 3, ("g0", 2, 0): 5,
                 ("g1", 0, 0): 5, ("g1", 0, 2): 9}
    spec = {"count": 1}
    assert traffic.crash_nodes(spec, placement, 3, 2, 10) == [3]
    placement[("g1", 1, 1)] = 5
    assert traffic.crash_nodes(spec, placement, 3, 2, 10) == [5]
    placement[("g1", 0, 1)] = 3
    assert traffic.crash_nodes(spec, placement, 3, 2, 10) == [3]
    assert traffic.crash_nodes({"count": 2}, placement, 3, 2, 10) == [3, 5]


@pytest.mark.parametrize("n,keys", [(4, 4), (4, 100), (1, 3)])
def test_draw_distinct_gives_different_keys(n, keys):
    order = list(range(500, 500 + keys))
    chooser = traffic.KeyChooser(order, 0.99, np.random.default_rng(5))
    for _ in range(50):
        drawn = chooser.draw_distinct(n)
        assert len(set(drawn)) == n and set(drawn) <= set(order)
    with pytest.raises(ValueError):
        chooser.draw_distinct(keys + 1)


def test_lost_data_objects():
    objects = {0: ("g0", 0), 1: ("g0", 1), 2: ("g1", 0)}
    placement = {("g0", 0, 0): 1, ("g0", 1, 0): 2, ("g0", 1, 1): 4, ("g1", 0, 5): 4}
    assert traffic.lost_data_objects(objects, placement, {4}, 2) == [1]


def test_open_schedule_same_work_for_every_seed():
    workload = {"rate": 50.0, "mix": {"get": 0.95, "put": 0.05}}
    for seed in (1, 2**31 + 5):
        rng = traffic.streams(seed)
        chooser = traffic.KeyChooser(list(range(600)), 0.99, rng["keys"])
        sched = traffic.open_schedule(workload, 30.0, chooser, rng["kinds"], rng["arrivals"])
        times = [d.at for d in sched]
        assert len(sched) == 1500 and times == sorted(times) and 0 <= times[0] <= times[-1] < 30
        assert sum(d.kind == "put" for d in sched) == 75


def test_even_arrivals_are_one_over_the_rate_apart():
    workload = {"rate": 16.0, "mix": {"get": 0.5, "put": 0.5}}
    rng = traffic.streams(9)
    chooser = traffic.KeyChooser(list(range(10)), 0.99, rng["keys"])
    sched = traffic.open_schedule(workload, 45.0, chooser, rng["kinds"], rng["arrivals"])
    gaps = np.diff([d.at for d in sched])
    assert len(sched) == 720 and np.allclose(gaps, 1 / 16) and 0 <= sched[0].at < 1 / 16
    assert sum(d.kind == "put" for d in sched) == 360


def test_loss_order_most_blocks_first_and_seed_free():
    placement = {("g0", 0, 0): 4, ("g0", 0, 1): 2, ("g0", 1, 0): 2, ("g1", 0, 0): 9,
                 ("g1", 1, 1): 4, ("g1", 2, 2): 7}
    assert traffic.loss_order(placement) == [2, 4, 7, 9]
    placement[("g1", 3, 3)] = 9
    placement[("g1", 4, 4)] = 9
    assert traffic.loss_order(placement) == [9, 2, 4, 7]
