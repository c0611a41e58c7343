"""Host milliseconds of ``pair_matrix_gates`` (the ``hq.pair`` spans) in
each traced ``simulate`` call, the mean over the traced calls."""

from hqbench.spans import mean_ms


def read(record):
    return mean_ms(record, ('hq.pair',))
