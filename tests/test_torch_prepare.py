"""The port's token fill of the split container (``prepare.token_container``
and ``token_containers``) on the CPU: bit for bit the host fold it
replaced, in float32 and float64, and its counters (``prepare.counts()``):
one fill a device, and no upload but the ``(n, 2)`` token table.
"""

import numpy as np
import pytest
import torch

from hybridq_tpu_torch.simulation import prepare
from hybridq_tpu_torch.simulation.sharded import ShardedEvolver

_UINT = {torch.float32: np.uint32, torch.float64: np.uint64}
_FTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _host_fill(state, n, ftype):
    """The fill as it was built on the host: ``np.multiply.outer`` folded
    over the row tokens (all but the last ``min(n, 7)``) and over the lane
    tokens, their outer product in the re half, zeros in the im half."""
    lo = min(n, 7)

    def amps(tokens):
        a = np.array([1.0], dtype=ftype)
        for s in tokens:
            a = np.multiply.outer(
                a, prepare.TOKEN_VECTORS[s].astype(ftype)).reshape(-1)
        return a

    out = np.zeros(2 ** (n + 1), dtype=ftype)
    out[:2 ** n] = np.multiply.outer(amps(state[:n - lo]),
                                     amps(state[n - lo:])).reshape(-1)
    return out


def _states(n):
    """The four one-token strings and three seeded mixed ones."""
    rng = np.random.default_rng(n)
    return [t * n for t in '01+-'] + [
        ''.join(rng.choice(list('01+-'), n)) for _ in range(3)]


CASES = [(n, s) for n in (1, 7, 8, 15, 20) for s in _states(n)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n, state', CASES)
def test_token_container_matches_host_fold(n, state, dtype):
    """Every bit of the container, signs of zero included, is the host
    fold's; one fill, whose only upload is the token table."""
    prepare.reset_counts()
    got = prepare.token_container(state, n, 'cpu', dtype)
    want = _host_fill(state, n, _FTYPE[dtype])
    assert got.dtype == dtype and got.shape == (2 ** (n + 1),)
    np.testing.assert_array_equal(got.numpy().view(_UINT[dtype]),
                                  want.view(_UINT[dtype]))
    counts = prepare.counts()
    assert counts['token_fills'] == 1
    assert 0 < counts['fill_upload_bytes'] <= 2 * n * got.element_size()
    prepare.reset_counts()
    assert prepare.counts() == {'token_fills': 0, 'fill_upload_bytes': 0}


@pytest.mark.parametrize('state', ['0' * 12, '+-01' * 3, '-1+0-1+0+-10'])
def test_sharded_fill_uploads_token_tables(state):
    """The sharded fill on four devices: one fill a device, each uploading
    only its local tokens' table, and the gathered state the host's."""
    ev = ShardedEvolver(len(state), devices=['cpu'] * 4)
    prepare.reset_counts()
    shards = ev.prepare_state(state)
    counts = prepare.counts()
    assert counts['token_fills'] == 4
    assert counts['fill_upload_bytes'] <= (
        4 * 2 * ev.n_local * shards[0].element_size())
    np.testing.assert_allclose(ev.gather(shards),
                               prepare.prepare_state(state), atol=1e-7)


def test_token_containers_fill_each_device():
    """Several devices: equal containers, none shared, one fill each."""
    prepare.reset_counts()
    outs = prepare.token_containers('+-01+-01+', 9, ['cpu'] * 3)
    assert len({o.data_ptr() for o in outs}) == 3
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert prepare.counts() == {'token_fills': 3,
                                'fill_upload_bytes': 3 * 9 * 2 * 4}
