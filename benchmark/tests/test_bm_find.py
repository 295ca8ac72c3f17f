"""The harness finds every configuration, traffic mix, kind, limit and
per-layer reader by its name in BENCHMARK.json, and an unknown name
raises; BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.spec()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_each_cell_finds_its_files(cell):
    entry, config_entry = harness.workload(cell)
    cfg = harness.config(entry['config'])
    mix = harness.traffic(entry['traffic'])
    assert harness.kind_module(mix['kind']).Work
    assert harness.limits(cell)
    assert config_entry['file'] == f'benchmark/configs/{entry["config"]}.json'
    for key in config_entry['reduced']:
        assert key in cfg


@pytest.mark.parametrize('metric', [m['name'] for m in SPEC['per_layer']])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(harness.reader(metric).read)


@pytest.mark.parametrize('finder, name', [
    (harness.config, 'no_such_config'), (harness.traffic, 'no_such_mix'),
    (harness.limits, 'no.such_cell'), (harness.kind_module, 'no_such_kind'),
    (harness.reader, 'no_such.metric'), (harness.workload, 'no.such')])
def test_unknown_names_raise(finder, name):
    with pytest.raises(harness.UnknownName):
        finder(name)


def test_readers_find_nothing_in_an_empty_record():
    rec = harness.Record()
    for m in SPEC['per_layer']:
        assert harness.reader(m['name']).read(rec) is None, m['name']


def test_contract_shape():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert len(json.dumps(SPEC)) < 64 * 1024
    e2e = {m['name']: m for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in SPEC[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in SPEC['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for w in SPEC['workloads']:
        assert len(w['why']) <= 200 and w['chips'] in (1, 4)
        reports = {m['name'] for m in SPEC['end_to_end']
                   if w['name'] in m.get('workloads', [w['name']])}
        assert 'setup_s' in reports and len(reports) >= 2
        assert any(w['name'] in m['workloads'] for m in SPEC['per_layer'])
    for m in SPEC['per_layer']:
        moved = e2e[m['moves']]
        for w in m['workloads']:
            assert w in moved.get('workloads', [w]), (m['name'], w)
        if m['name'].endswith('roofline') or '_roofline.' in m['name']:
            assert m['unit'] == '%'
