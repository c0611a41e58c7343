"""The Sycamore layout and the ABCDCDAB generator."""

import numpy as np
import pytest

import _small  # noqa: F401
from hqbench import circuits


def test_layout_is_sycamore():
    from hybridq_tpu_torch.architecture.google import sycamore

    assert circuits.layout() == sycamore.layout
    assert len(circuits.layout()) == 53
    for k in 'ABCD':
        assert circuits.layer_couplers(circuits.layout(), k) == \
            sycamore.get_layer(k)


def test_patch_of_32():
    p = circuits.patch(32)
    assert len(p) == 32 and len(circuits.couplers(p)) == 48
    assert [len(circuits.layer_couplers(p, k)) for k in 'ABCD'] == \
        [11, 11, 15, 11]


@pytest.mark.parametrize('seed', [0, 7, 2 ** 31 + 1, 12345678901234])
def test_rqc_repeats_for_a_seed(seed):
    a = circuits.rqc(32, 14, [seed, 1, 0])
    assert a == circuits.rqc(32, 14, [seed, 1, 0])
    assert len(a) == 618
    assert sum(name == 'FSIM' for name, _, _ in a) == 170
    b = circuits.rqc(32, 14, [seed, 1, 1])
    assert [q for _, q, _ in a] == [q for _, q, _ in b]
    assert [g for g, _, _ in a] != [g for g, _, _ in b]


def test_one_qubit_gates_are_uniform():
    names = [n for n, q, _ in circuits.rqc(32, 14, 3) if len(q) == 1]
    counts = np.array([names.count(n) for n, _ in circuits.ONE_QUBIT_GATES])
    assert counts.sum() == 448 and counts.min() > 120
