"""The traffic and the weights reproduce by seed, and every seed does the
same work."""

import numpy as np
import torch

from benchmark import harness, traffic, weights
from benchmark.tests import tiny

BIG = 2 ** 31 + 12345


def test_sources_reproduce_by_seed():
    a = traffic.sources(BIG, 3, 2, 800, 8000, "cpu")
    b = traffic.sources(BIG, 3, 2, 800, 8000, "cpu")
    c = traffic.sources(BIG + 1, 3, 2, 800, 8000, "cpu")
    assert a.shape == (3, 2, 800) and torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(traffic.mixtures(BIG, 3, 2, 800, 8000, "cpu"), a.sum(1))
    assert 0.01 < float(a.abs().max()) < 1.0


def test_weights_reproduce_by_seed_in_the_port_layout():
    from convtasnet_torch.config import ConvTasNetConfig
    from convtasnet_torch.models.conv_tasnet import init_params

    a, b = weights.make(tiny.MODEL, BIG, "cpu"), weights.make(tiny.MODEL, BIG, "cpu")
    port, _ = init_params(torch.Generator().manual_seed(0), ConvTasNetConfig(**tiny.MODEL))
    from benchmark.reference.convtasnet import leaves

    la, lb, lp = leaves(a), leaves(b), leaves(port)
    assert [n for n, _ in la] == [n for n, _ in lp]
    for (n, x), (_, y), (_, z) in zip(la, lb, lp):
        assert torch.equal(x, y) and x.shape == z.shape and x.dtype == z.dtype, n
        if n.endswith("prelu"):
            assert torch.all(x == 0.25)
        elif x.numel() >= 256:  # the same xavier-normal scale as the port's own init
            assert 0.7 < float(x.std()) / float(z.std()) < 1.4, n


def test_length_grid_and_order():
    g = traffic.length_grid(16000, 64000, 100)
    assert g[0] == 16000 and g[-1] == 64000 and len(g) == 481
    assert len({traffic.padded(n, 4000) for n in g}) == 13
    o1, o2 = traffic.order(BIG, 481), traffic.order(BIG + 1, 481)
    assert sorted(o1) == list(range(481)) and o1 == traffic.order(BIG, 481) and o1 != o2


def test_one_length_gives_distinct_utterances_of_it():
    t = dict(min_samples=48000, max_samples=48000, grid_step=4000, utterances=64)
    assert traffic.utterance_lengths(t) == [48000] * 64
    assert traffic.utterance_lengths({**t, "max_samples": 56000, "utterances": 0}) == [
        48000, 52000, 56000]


def test_reservoir_reproduces_by_seed():
    def draw(seed):
        r = harness.Reservoir(3, seed)
        for i in range(100):
            r.offer(lambda: i)
        return r.items

    assert draw(BIG) == draw(BIG) and len(draw(BIG)) == 3 and draw(BIG) != draw(BIG + 5)


def test_every_seed_does_the_same_work():
    cell = harness.spec.cell("causal.stream.b1x20ms")
    over = {"traffic": {**tiny.TRAFFIC[cell.name], "max_samples": 3200, "grid_step": 800}}
    a = harness.make_driver(cell, BIG, "cpu", over)
    b = harness.make_driver(cell, BIG + 1, "cpu", over)
    assert sorted(a.lengths) == sorted(b.lengths) == [1600, 2400, 3200] and a.order != b.order
    cell = harness.spec.cell("paper.separate.b1x6s")
    a = harness.make_driver(cell, BIG, "cpu", tiny.overrides(cell.name))
    b = harness.make_driver(cell, BIG + 1, "cpu", tiny.overrides(cell.name))
    assert sorted(a.lengths) == sorted(b.lengths) and a.order != b.order
    assert np.array_equal(sorted(np.array(a.lengths)[a.order]), sorted(b.lengths))
