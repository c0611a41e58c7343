"""Host milliseconds of the program's front end in each traced
``simulate`` call: the union of its ``hq.preprocess`` (``simplify``
inside), ``hq.compress`` and ``hq.block_matrices`` spans, the mean over
the traced calls.  Unlike ``front_end_ms`` it does not stop at the first
device activity."""

from hqbench.spans import mean_ms


def read(record):
    return mean_ms(record, ('hq.preprocess', 'hq.compress',
                            'hq.block_matrices'))
