"""``correct`` on the host at a small size: a sound run is correct; the
control (the plain reference in TF32 in the program's place) and each
fault planted in the timed path are not."""

import numpy as np
import pytest

import _small
import calibrate


@pytest.fixture(scope='module')
def plan(tmp_path_factory):
    path = tmp_path_factory.mktemp('plan') / 'plan.pkl'
    assert _small.make_plan(path) >= 8
    return path


def test_sound_sv_run_is_correct():
    result, checks = _small.run(_small.SV_CELL, *_small.small_sv())
    assert result['correct'], checks
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert 0 < checks['amp_gap'][0] < checks['amp_gap'][1] / 10


def test_sound_tn_run_is_correct(plan):
    result, checks = _small.run(_small.TN_CELL, *_small.small_tn(plan))
    assert result['correct'], checks
    assert checks['sum_gap'][0] < checks['sum_gap'][1] / 10


def test_sv_control_is_not_correct():
    config, traffic = _small.small_sv()
    with calibrate.control(config):
        result, checks = _small.run(_small.SV_CELL, config, traffic)
    assert not result['correct']
    assert checks['amp_gap'][0] > checks['amp_gap'][1]


def test_tn_control_is_not_correct(plan):
    config, traffic = _small.small_tn(plan)
    with calibrate.control(config):
        result, checks = _small.run(_small.TN_CELL, config, traffic)
    assert not result['correct']
    assert checks['sum_gap'][0] > checks['sum_gap'][1]


def test_calibration_readings(plan):
    for config, traffic, name in (
            _small.small_sv() + ('amp_gap',),
            _small.small_tn(plan) + ('sum_gap',)):
        program = calibrate.reading(7, config, traffic, 'cpu')[name]
        with calibrate.control(config):
            control = calibrate.reading(7, config, traffic, 'cpu',
                                        warm=False)[name]
        assert program < config['checks'][name] and control > 10 * program


def test_sv_step_left_unchanged_is_not_correct(monkeypatch):
    from hybridq_tpu_torch.simulation import fused_kernels

    real, calls = fused_kernels.apply_bits, []

    def apply_bits(state, U, bits):
        calls.append(1)
        return state if len(calls) % 5 == 3 else real(state, U, bits)
    monkeypatch.setattr(fused_kernels, 'apply_bits', apply_bits)
    result, _ = _small.run(_small.SV_CELL, *_small.small_sv())
    assert calls and not result['correct']


def test_sv_answer_altered_is_not_correct(monkeypatch):
    from hybridq_tpu_torch.simulation.kernels import IndexedEvolver

    real = IndexedEvolver.gather

    def gather(self, state, complex_type='complex64'):
        return real(self, state, complex_type) * np.exp(0.01j)
    monkeypatch.setattr(IndexedEvolver, 'gather', gather)
    result, _ = _small.run(_small.SV_CELL, *_small.small_sv())
    assert not result['correct']


def test_tn_half_the_slices_is_not_correct(monkeypatch, plan):
    from hybridq_tpu_torch.simulation.tn.contract import SlicedContractor

    real = SlicedContractor.contract_torch

    def contract_torch(self, device=None, slice_range=None):
        a, b = slice_range
        return 2 * real(self, device, (a, a + (b - a) // 2))
    monkeypatch.setattr(SlicedContractor, 'contract_torch', contract_torch)
    result, _ = _small.run(_small.TN_CELL, *_small.small_tn(plan))
    assert not result['correct']


def test_tn_answer_altered_is_not_correct(monkeypatch, plan):
    from hybridq_tpu_torch.simulation.tn.contract import SlicedContractor

    real = SlicedContractor.contract_torch

    def contract_torch(self, device=None, slice_range=None):
        return real(self, device, slice_range) * np.complex64(1.01)
    monkeypatch.setattr(SlicedContractor, 'contract_torch', contract_torch)
    result, _ = _small.run(_small.TN_CELL, *_small.small_tn(plan))
    assert not result['correct']
