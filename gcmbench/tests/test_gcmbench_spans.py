"""The attribution of ``gcmbench/spans.py`` and its readers against
hand-made traces: innermost spans, idle time clipped to the device's
gaps, and the readers' None where there is nothing to read."""

import pytest

from gcmbench import harness, spans
from gcmbench.tracing import Trace

# one step of 10 s: physics 1-5 holding radiation 2-4 holding the gas
# optics 2-3; dynamics 5-9 holding transport 6-8; the step's own 0-1 and
# 9-10; an aten op inside the physics, which is no program span
HOST = [('climt.step', 0.0, 10.0), ('climt.physics', 1.0, 5.0),
        ('climt.radiation', 2.0, 4.0), ('climt.gas_optics', 2.0, 3.0),
        ('aten::mul', 1.5, 1.6), ('climt.dynamics', 5.0, 9.0),
        ('climt.transport', 6.0, 8.0)]
# device operations 0-0.5, 1.5-2.5, 3.5-7 and 8.5-10: gaps 0.5-1.5,
# 2.5-3.5, 7-8.5
DEVICE = [('k', 0.0, 0.5), ('k', 1.5, 2.5), ('k', 3.5, 7.0),
          ('k', 8.5, 10.0)]


def record(host=HOST, steps=1):
    return {'trace': Trace(DEVICE, list(host), 10.0), 'trace_steps': steps}


def test_a_child_span_takes_its_time_from_the_parent():
    host, _ = spans.self_seconds(record()['trace'])
    assert host == pytest.approx({
        'climt.step': 2.0, 'climt.physics': 2.0, 'climt.radiation': 1.0,
        'climt.gas_optics': 1.0, 'climt.dynamics': 2.0,
        'climt.transport': 2.0})
    rec = record()
    assert spans.layer_ms(rec, 'radiation') == pytest.approx(2000.0)
    assert spans.layer_ms(rec, 'physics') == pytest.approx(2000.0)
    assert spans.layer_ms(rec, 'dynamics') == pytest.approx(2000.0)
    assert spans.layer_ms(rec, 'transport') == pytest.approx(2000.0)


def test_a_span_that_starts_with_its_parent_is_the_inner_one():
    host = [('climt.gas_optics', 2.0, 3.0), ('climt.radiation', 2.0, 4.0)]
    got, _ = spans.self_seconds(Trace(DEVICE, host, 10.0))
    assert got == pytest.approx({'climt.radiation': 1.0,
                                 'climt.gas_optics': 1.0})


def test_idle_time_is_clipped_to_the_gaps():
    _, idle = spans.self_seconds(record()['trace'])
    # gap 0.5-1.5: step 0.5-1, physics 1-1.5; 2.5-3.5: gas optics 2.5-3,
    # radiation 3-3.5; 7-8.5: transport 7-8, dynamics 8-8.5
    assert idle == pytest.approx({
        'climt.step': 0.5, 'climt.physics': 0.5, 'climt.gas_optics': 0.5,
        'climt.radiation': 0.5, 'climt.transport': 1.0,
        'climt.dynamics': 0.5})
    rec = record(steps=2)
    assert spans.layer_ms(rec, 'radiation', idle=True) == pytest.approx(500.)
    assert spans.layer_ms(rec, 'transport', idle=True) == pytest.approx(500.)
    total = sum(spans.layer_ms(rec, layer, idle=True)
                for layer in ('radiation', 'physics', 'dynamics',
                              'transport'))
    gaps = sum(e - s for s, e in rec['trace'].gaps())
    assert total + 1e3 * idle['climt.step'] / 2 == pytest.approx(
        1e3 * gaps / 2)


def test_layers_and_the_steps_remainder_sum_to_the_steps_union():
    # a second step: its physics 12.5-13, then an SW solver 13-13.5
    host = HOST + [('climt.step', 12.0, 14.0), ('climt.physics', 12.5, 13.0),
                   ('climt.sw_solver', 13.0, 13.5)]
    rec = {'trace': Trace(DEVICE, host, 14.0), 'trace_steps': 2}
    own, _ = spans.self_seconds(rec['trace'])
    layers = sum(spans.layer_ms(rec, layer) for layer in (
        'radiation', 'physics', 'dynamics', 'transport'))
    union = 10.0 + 2.0
    assert layers + 1e3 * own['climt.step'] / 2 == pytest.approx(
        1e3 * union / 2)


@pytest.mark.parametrize('name', [
    '%s_ms.%s' % (kind, layer) for layer in spans.LAYERS
    for kind in ('host', 'idle')])
def test_each_reader_reads_none_without_its_spans(name):
    reader = harness.load_module('metrics', name)
    assert reader.read({}) is None
    no_spans = [op for op in HOST if not op[0].startswith('climt.')]
    assert reader.read(record(no_spans)) is None
    assert reader.read({'trace': Trace(DEVICE, HOST, 10.0)}) is None
    layer = name.split('.', 1)[1]
    mine = [op for op in HOST if op[0] in spans.LAYERS[layer]]
    if mine:
        assert reader.read(record()) == pytest.approx(spans.layer_ms(
            record(), layer, idle=name.startswith('idle')))


def test_span_metrics_name_the_layers_of_perf_md():
    bench = harness.load_json(harness.ROOT, 'BENCHMARK.json')
    mine = {m['name']: m['layer'] for m in bench['per_layer']
            if m['source'] == 'program_span'}
    assert set(mine) == {'%s_ms.%s' % (kind, layer)
                         for layer in spans.LAYERS
                         for kind in ('host', 'idle')}
    assert set(mine.values()) == {'radiation', 'column physics', 'dynamics',
                                  'transport', 'SW solver'}
