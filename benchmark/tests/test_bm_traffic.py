"""Each traffic mix's seeded inputs: equal for equal seeds, different for
different ones, of the same sizes whatever the seed."""

import pytest
import torch

from benchmark import harness
from benchmark.traffic import Traffic, subseed

MIXES = ('synth_b8', 'reenact_b1', 'train_b4')
BIG = 2 ** 31 + 12345


def _units(mix_name, seed, units=(0, 1, 7)):
    mix = dict(harness.traffic(mix_name), resolution=16)
    t = Traffic(mix, seed, torch.device('cpu'))
    return [t.unit(i) for i in units], t


@pytest.mark.parametrize('mix_name', MIXES)
def test_same_seed_same_inputs(mix_name):
    a, _ = _units(mix_name, BIG)
    b, _ = _units(mix_name, BIG)
    for ua, ub in zip(a, b):
        assert ua.keys() == ub.keys()
        for k in ua:
            assert torch.equal(ua[k], ub[k]), k


@pytest.mark.parametrize('mix_name', MIXES)
def test_other_seed_other_inputs_same_sizes(mix_name):
    a, _ = _units(mix_name, BIG)
    b, _ = _units(mix_name, BIG + 1)
    for ua, ub in zip(a, b):
        for k in ua:
            assert ua[k].shape == ub[k].shape, k
        assert not torch.equal(ua['z'], ub['z'])
        assert not torch.equal(ua['v'], ub['v'])


@pytest.mark.parametrize('mix_name', MIXES)
def test_units_differ(mix_name):
    (u0, u1, _), _ = _units(mix_name, 7)
    assert not torch.equal(u0['v'], u1['v'])
    assert not torch.equal(u0['c'], u1['c'])


def test_subseed_takes_any_integer():
    seeds = {subseed(s, 'unit', 3) for s in (0, 1, 2 ** 31, 2 ** 40, -5)}
    assert len(seeds) == 5
    assert all(0 <= s < 2 ** 63 for s in seeds)


def test_reenact_walk_is_smooth_and_bounded():
    units, t = _units('reenact_b1', BIG, units=range(0, 200))
    v = torch.stack([u['v'][0] for u in units])
    step = (v[1:] - v[:-1]).abs().max()
    amp = harness.traffic('reenact_b1')['expression']['amplitude']
    assert float(step) < amp
    assert float((v - t.head).abs().max()) < 6 * amp
    c = torch.stack([u['c'][0] for u in units])
    assert float((c[1:] - c[:-1]).abs().max()) < 0.1


def test_cameras_look_at_the_head():
    (u,), t = _units('synth_b8', BIG, units=(0,))
    pose = u['c'][:, :16].reshape(-1, 4, 4)
    origin = pose[:, :3, 3]
    assert torch.allclose(origin.norm(dim=1), torch.full((8,), 2.7),
                          atol=1e-5)
    frontal = t.frontal(1)[0, :16].reshape(4, 4)
    assert torch.allclose(frontal[:3, 3], torch.tensor([0., 0., 2.7]),
                          atol=1e-5)
