"""The port's fabric model (``repro_torch.storage.netmodel``) against the
JAX package's: the cases of tests/test_netmodel.py (fifo vs quantum
sharing, weighted-fair tenants, starvation and deadline accounting, the
port timeline) run on both modules with the same transfer schedules,
every completion time, byte count and counter equal (tolerance 0), then
the reference's claims checked on the port's numbers."""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import repro.storage.netmodel as jnet  # noqa: E402
import repro_torch.storage.netmodel as tnet  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: torch's thread pool costs more than it saves, and the
    suite runs beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MB = 1_000_000
SIDES = {"jax": jnet, "torch": tnet}


def both(fn, *args):
    return fn(jnet, *args), fn(tnet, *args)


def _sim(net, **kw):
    return net.NetSimulator(net.ClusterProfile.network_critical(), **kw)


def _counters(sim):
    return (sim.total_bytes, dict(sim.class_bytes), dict(sim.tenant_wait_max),
            dict(sim.tenant_transfers), dict(sim.tenant_deadline_met),
            dict(sim.tenant_deadline_missed), dict(sim.class_makespan))


def test_constants_equal():
    for name in ("BACKGROUND", "FOREGROUND", "FOREGROUND_TENANT", "REPAIR_TENANT"):
        assert getattr(tnet, name) == getattr(jnet, name), name
    assert vars(tnet.ClusterProfile.network_critical()) == vars(
        jnet.ClusterProfile.network_critical())
    assert vars(tnet.ClusterProfile.computation_critical()) == vars(
        jnet.ClusterProfile.computation_critical())


def _hol(net):
    long_bg, fg = 24 * MB, 512 * 1024
    fifo = _sim(net, background_share=0.5, mode="fifo")
    fifo.transfer(net.Transfer(0, 1, long_bg, priority=net.BACKGROUND))
    fifo_fg = fifo.transfer(net.Transfer(0, 1, fg, not_before=1.0))
    quant = _sim(net, background_share=0.5, mode="quantum")
    bg_end = quant.transfer(net.Transfer(0, 1, long_bg, priority=net.BACKGROUND))
    quant_fg = quant.transfer(net.Transfer(0, 1, fg, not_before=1.0))
    return fifo_fg, quant_fg, bg_end, quant.quantum_bytes, _counters(quant)


def test_foreground_read_bounded_under_long_background_transfer():
    ref, port = both(_hol)
    assert port == ref
    fifo_fg, quant_fg, bg_end, quantum, _ = port
    bw = tnet.ClusterProfile.network_critical().node_bandwidth
    assert fifo_fg > 4.0
    assert quant_fg - 1.0 <= (512 * 1024 / bw) / 0.5 + 2 * quantum / bw
    assert quant_fg - 1.0 < (fifo_fg - 1.0) / 10
    assert bg_end == pytest.approx(24 * MB / (0.5 * bw), rel=0.02)


def _conserved(net, mode):
    sim = _sim(net, background_share=0.25, mode=mode)
    ends = [sim.transfer(net.Transfer(s, d, b, nb, p)) for s, d, b, nb, p in (
        (0, 1, 3 * MB, 0.0, net.BACKGROUND), (0, 2, 1 * MB, 0.05, net.FOREGROUND),
        (3, 1, 2 * MB, 0.1, net.BACKGROUND), (0, 1, 512 * 1024, 0.12, net.FOREGROUND))]
    return ends, _counters(sim)


@pytest.mark.parametrize("mode", ["fifo", "quantum"])
def test_schedule_equal_and_bytes_conserved(mode):
    ref, port = both(_conserved, mode)
    assert port == ref
    other = _conserved(tnet, "quantum" if mode == "fifo" else "fifo")
    assert port[1][:2] == other[1][:2]
    assert port[1][1] == {tnet.FOREGROUND: 1 * MB + 512 * 1024, tnet.BACKGROUND: 5 * MB}


def _small_stream(net):
    sim = _sim(net, background_share=0.5, mode="quantum")
    block = 64 * 1024
    ends = [sim.transfer(net.Transfer(0, 1, block, priority=net.BACKGROUND))
            for _ in range(32)]
    return ends, sim.transfer(net.Transfer(0, 1, block, not_before=0.0))


def test_quantum_stream_of_small_background_transfers_respects_share():
    ref, port = both(_small_stream)
    assert port == ref
    ends, fg_end = port
    alone = 32 * 64 * 1024 / tnet.ClusterProfile.network_critical().node_bandwidth
    assert ends[-1] == pytest.approx(2 * alone, rel=0.05) and fg_end < ends[-1] / 4


def _fifo_within_class(net):
    out = []
    for mode in ("fifo", "quantum"):
        sim = _sim(net, mode=mode)
        out.append((sim.transfer(net.Transfer(0, 1, 6 * MB)),
                    sim.transfer(net.Transfer(0, 1, 6 * MB))))
    sim = _sim(net, mode="quantum")
    out.append(sim.transfer(net.Transfer(0, 1, MB, not_before=3.0)))
    return out


def test_quantum_foreground_fifo_and_not_before():
    ref, port = both(_fifo_within_class)
    assert port == ref
    for a, b in port[:2]:
        assert a == pytest.approx(0.5) and b == pytest.approx(1.0)
    bw = tnet.ClusterProfile.network_critical().node_bandwidth
    assert port[2] == pytest.approx(3.0 + MB / bw)


@pytest.mark.parametrize("kw", [{"mode": "wfq"}, {"quantum_bytes": 0},
                                {"background_share": 0.0}, {"tenant_weights": {"a": 0.0}},
                                {"tenant_weights": {"a": 1.5}}])
def test_validation_rejects_on_both(kw):
    for net in SIDES.values():
        with pytest.raises(ValueError):
            _sim(net, **kw)


WEIGHTS = [
    {"a": 0.5, "b": 0.25, "c": 0.25},
    {"a": 0.5, "b": 0.3, "c": 0.2},
    {"a": 0.4, "b": 0.4, "c": 0.2},
    {"a": 0.6, "b": 0.2, "c": 0.1},
]


def _weighted(net, weights):
    sim = _sim(net, mode="quantum", tenant_weights=weights)
    nbytes = 48 * sim.quantum_bytes
    ends = {t: sim.transfer(net.Transfer(0, 1, nbytes, tenant=t)) for t in weights}
    return ends, nbytes, sim.quantum_bytes, _counters(sim)


@pytest.mark.parametrize("weights", WEIGHTS)
def test_tenant_weights_equal_and_proportional(weights):
    ref, port = both(_weighted, weights)
    assert port == ref
    ends, nbytes, quantum, counters = port
    bw = tnet.ClusterProfile.network_critical().node_bandwidth
    slack = quantum / bw
    for t, w in weights.items():
        expected = nbytes / (w * bw)
        assert expected - slack / w - 1e-9 <= ends[t] <= expected + 2 * slack + 1e-9
    assert counters[0] == len(weights) * nbytes
    assert counters[1] == {t: nbytes for t in weights}
    ordered = sorted(weights, key=weights.get, reverse=True)
    for hi, lo in zip(ordered, ordered[1:]):
        assert nbytes / ends[hi] >= nbytes / ends[lo] - 1e-9


def _shim(net):
    legacy = _sim(net, background_share=0.5, mode="quantum")
    named = _sim(net, mode="quantum",
                 tenant_weights={net.FOREGROUND_TENANT: 1.0, net.REPAIR_TENANT: 0.5})
    ends = []
    for nbytes, t0, cls in ((24 * MB, 0.0, "bg"), (512 * 1024, 1.0, "fg"),
                            (3 * MB, 1.2, "bg"), (2 * MB, 1.3, "fg")):
        bg = cls == "bg"
        ends.append((
            legacy.transfer(net.Transfer(0, 1, nbytes, not_before=t0,
                                         priority=net.BACKGROUND if bg else net.FOREGROUND)),
            named.transfer(net.Transfer(0, 1, nbytes, not_before=t0,
                                        tenant=net.REPAIR_TENANT if bg
                                        else net.FOREGROUND_TENANT)),
        ))
    return ends, _counters(legacy), _counters(named)


def test_background_share_shim_reproduces_two_class_schedule():
    ref, port = both(_shim)
    assert port == ref
    ends, legacy, named = port
    for leg, nam in ends:
        assert nam == pytest.approx(leg, abs=1e-12)
    assert legacy[0] == named[0]
    assert legacy[1][tnet.BACKGROUND] == named[1][tnet.REPAIR_TENANT]


def _defaults(net):
    sim = _sim(net, mode="quantum", tenant_weights={"slow": 0.25})
    out = [sim.transfer(net.Transfer(0, 1, MB, tenant="never-registered")),
           sim.weight_of("never-registered"), sim.weight_of("slow")]
    for mode in ("fifo", "quantum"):
        sim = _sim(net, background_share=0.5, mode=mode)
        out += [sim.weight_of(2), sim.weight_of(net.FOREGROUND),
                sim.transfer(net.Transfer(0, 1, MB, priority=2))]
    return out


def test_unknown_tenant_and_legacy_int_priority():
    ref, port = both(_defaults)
    assert port == ref
    bw = tnet.ClusterProfile.network_critical().node_bandwidth
    assert port[0] == pytest.approx(MB / bw) and port[1:3] == [1.0, 0.25]
    for i in (3, 6):
        assert port[i:i + 2] == [0.5, 1.0]
        assert port[i + 2] == pytest.approx(MB / (0.5 * bw), rel=0.02)


def _accounting(net):
    sim = _sim(net, mode="quantum")
    sim.transfer(net.Transfer(0, 1, 12 * MB, tenant="a"))
    end_b = sim.transfer(net.Transfer(0, 1, MB, tenant="b"))
    dl = _sim(net, mode="quantum")
    dur = MB / dl.profile.node_bandwidth
    dl.transfer(net.Transfer(0, 1, MB, tenant="t", deadline=dur * 2))
    dl.transfer(net.Transfer(0, 1, MB, tenant="t", deadline=dur / 2))
    dl.transfer(net.Transfer(0, 1, MB, tenant="t"))
    return (end_b, _counters(sim), _counters(dl), dl.deadline_miss_rate("t"),
            dl.deadline_miss_rate("other"))


def test_starvation_and_deadline_accounting():
    ref, port = both(_accounting)
    assert port == ref
    end_b, starve, deadline, miss, other = port
    assert starve[2]["a"] == pytest.approx(0.0) and starve[2]["b"] == pytest.approx(1.0)
    assert starve[3] == {"a": 1, "b": 1}
    assert end_b == pytest.approx(1.0 + MB / tnet.ClusterProfile.network_critical()
                                  .node_bandwidth)
    assert deadline[4] == {"t": 1} and deadline[5] == {"t": 1}
    assert miss == pytest.approx(0.5) and other == 0.0


def _timeline(net):
    tl = net._PortTimeline()
    tl.occupy(1.0, 2.0)
    tl.occupy(3.0, 4.0)
    out = [tl.next_fit(0.0, 1.0), tl.next_fit(0.5, 1.0), tl.next_fit(0.5, 2.0)]
    tl.occupy(2.0, 3.0)
    return out + [list(tl.starts), list(tl.ends), tl.next_fit(0.0, 0.5), tl.next_fit(1.5, 0.5)]


def test_port_timeline_first_fit_and_merge():
    ref, port = both(_timeline)
    assert port == ref == [0.0, 2.0, 4.0, [1.0], [4.0], 0.0, 4.0]
