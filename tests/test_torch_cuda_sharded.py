"""The sharded engine over four cards of one process, against the straight
engine on one card.

Every test here needs four CUDA devices and skips without them.  The
file imports nothing of JAX and needs no fixture of ``tests/conftest.py``:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_sharded.py

At n = 26 each card holds a 2^24-amplitude shard, every exchange crosses
two cards, and the result stays on the cards (``ShardedState``).
Tolerance: max|d| <= 1e-5 on the unit-norm state, as in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from hybridq_tpu_torch import Circuit, Gate
from hybridq_tpu_torch.extras.random import get_rqc
from hybridq_tpu_torch.simulation import sharded, simulate

ATOL = 1e-5
N = 26

pytestmark = pytest.mark.gpu


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_cuda_sharded.py)")
    return [torch.device('cuda', i) for i in range(4)]


@pytest.mark.parametrize('mode', ['indexed', 'traced'])
@pytest.mark.parametrize('given', [True, False])
def test_four_cards_match_straight(cards, mode, given):
    """Gates on the global qubits, a layout left permuted: the amplitudes
    read on the cards and the gathered state equal the straight engine's;
    each exchange sends two shards' worth of bytes between the cards.
    ``given=False`` leaves the mesh to ``simulate`` (every visible card),
    which is four cards only on a four-card machine."""
    if not given and torch.cuda.device_count() != 4:
        pytest.skip("simulate's default mesh is every visible card")
    np.random.seed(26)
    # an H layer first, so that every qubit is active
    c = Circuit(Gate('H', qubits=[q]) for q in range(N)) + \
        get_rqc(N, 60, indexes=list(range(N)))
    where = {'devices': cards} if given else {}
    sharded.reset_counts()
    st = simulate(c, '0', optimize='evolution-sharded', simplify=False,
                  return_numpy_array=False, sharded_mode=mode, **where)
    got = sharded.counts()
    assert [s.device for s in st.shards] == cards
    assert st.perm != list(range(N)) and got['exchange'] > 0
    assert got['exchange_bytes'] == got['exchange'] * 2 * 8 * 2 ** (N - 2)
    want = simulate(c, '0', optimize='evolution', simplify=False,
                    return_numpy_array=False, device=cards[0]).reshape(-1)
    index = torch.as_tensor(np.random.default_rng(1).integers(
        0, 2 ** N, 2 ** 16), device=cards[0])
    amps = st.amplitudes(index)
    assert amps.device == cards[0]
    assert float((amps - want[index]).abs().max()) <= ATOL
    np.testing.assert_allclose(st.gather().reshape(-1),
                               want.cpu().numpy(), atol=ATOL)
