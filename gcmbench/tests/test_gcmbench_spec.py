"""BENCHMARK.json against the benchmark's contract, and every file a
cell, a configuration, a traffic mix or a metric needs."""

import json
import math
import os
import re

import pytest

from gcmbench import harness

BENCH = harness.load_json(harness.ROOT, 'BENCHMARK.json')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


def one_line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    size = os.path.getsize(os.path.join(harness.ROOT, 'BENCHMARK.json'))
    assert size <= 64 * 1024
    assert 1 <= len(BENCH['command']) <= 32
    assert all(one_line(w) for w in BENCH['command'])
    assert all(not w.startswith('/') and '..' not in w
               for w in BENCH['command'])


def test_paths_hold_the_benchmark_alone():
    assert 1 <= len(BENCH['paths']) <= 16
    for p in BENCH['paths']:
        assert re.match(r'^[A-Za-z0-9_./-]{1,200}$', p)
        assert os.path.isdir(os.path.join(harness.ROOT, p))
        assert not p.endswith('_torch')
    assert BENCH['command'][1].startswith(BENCH['paths'][0] + '/')


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH['run_seconds']
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize('metric', METRICS, ids=lambda m: m['name'])
def test_metric_names_units_and_keys(metric):
    assert NAME.match(metric['name'])
    assert UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    assert metric['source'] in SOURCES
    if metric in BENCH['end_to_end']:
        assert set(metric) <= {'name', 'unit', 'better', 'bound', 'source',
                               'workloads'}
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25
    else:
        assert set(metric) <= {'name', 'unit', 'better', 'source', 'layer',
                               'moves', 'workloads'}
        assert one_line(metric['layer'])
        assert metric['moves'] in {m['name'] for m in BENCH['end_to_end']}
    if metric['name'].endswith('_roofline') or 'mfu' in metric['name']:
        assert metric['unit'] == '%'


def test_names_are_unique():
    for group in (METRICS, BENCH['workloads'], BENCH['configs']):
        names = [x['name'] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize('config', BENCH['configs'],
                         ids=lambda c: c['name'])
def test_config_entry_and_file(config):
    assert set(config) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(config['name'])
    assert one_line(config['source']) and one_line(config['why'])
    assert config['file'].startswith(BENCH['paths'][0] + '/')
    data = harness.load_json(harness.ROOT, config['file'])
    assert data['name'] == config['name']
    assert len(config['reduced']) <= 16
    assert all(NAME.match(k) for k in config['reduced'])
    # each key changed from the source is a key of the file, and says why
    assert data['reduced'] == config['reduced']
    for key in config['reduced']:
        assert key in data or key in data.get('build', {}), key
        assert one_line(data['departures'][key]), key
    assert any(w['config'] == config['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda w: w['name'])
def test_cell_files_exist(cell):
    assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(cell['name']) and NAME.match(cell['traffic'])
    assert cell['chips'] in (1, 4) and one_line(cell['why'])
    ctx = harness.cell_context(BENCH, cell['name'], 1, 1.0, False, 0.0,
                               device='cpu')
    driver = os.path.join(harness.HERE, 'drivers',
                          ctx.cell['driver'] + '.py')
    assert os.path.exists(driver)
    for name, limit in ctx.cell['limits'].items():
        assert 0 < limit < math.inf, name


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda w: w['name'])
def test_each_cell_reports_setup_another_e2e_and_a_layer(cell):
    e2e = [m['name'] for m in BENCH['end_to_end']
           if cell['name'] in m.get('workloads', [cell['name']])]
    assert 'setup_s' in e2e and len(e2e) >= 2
    layers = [m for m in BENCH['per_layer']
              if cell['name'] in m.get('workloads', [])]
    assert layers
    ctx = harness.cell_context(BENCH, cell['name'], 1, 1.0, False, 0.0,
                               device='cpu')
    assert ctx.cell['throughput'] in e2e


@pytest.mark.parametrize('metric', BENCH['per_layer'],
                         ids=lambda m: m['name'])
def test_per_layer_reader_and_moves(metric):
    assert os.path.exists(harness.module_path('metrics', metric['name']))
    reader = harness.load_module('metrics', metric['name'])
    assert reader.read({}) is None
    moves = next(m for m in BENCH['end_to_end']
                 if m['name'] == metric['moves'])
    for cell in metric['workloads']:
        assert cell in moves.get('workloads', [cell])


def test_four_chip_cells_within_the_quarter():
    fours = [w for w in BENCH['workloads'] if w['chips'] == 4]
    assert len(fours) <= max(1, len(BENCH['workloads']) // 4)


def test_layers_share_names():
    layers = {m['layer'] for m in BENCH['per_layer']}
    assert layers <= {'model step', 'radiation', 'gas optics',
                      'LW flux sweep', 'dispatch', 'device', 'collectives'}
