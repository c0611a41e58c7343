"""Noise layer: channels and circuit noise injection (host copies of
``hybridq_tpu/noise``)."""

from hybridq_tpu_torch.noise.channel.channel import (
    BaseChannel, MatrixChannel, GlobalPauliChannel, LocalPauliChannel,
    LocalDepolarizingChannel, GlobalDepolarizingChannel,
    LocalDephasingChannel, AmplitudeDampingChannel)
from hybridq_tpu_torch.noise.utils import (add_depolarizing_noise,
                                     add_dephasing_noise,
                                     add_amplitude_damping_noise)

__all__ = [
    'BaseChannel', 'MatrixChannel', 'GlobalPauliChannel',
    'LocalPauliChannel', 'LocalDepolarizingChannel',
    'GlobalDepolarizingChannel', 'LocalDephasingChannel',
    'AmplitudeDampingChannel', 'add_depolarizing_noise',
    'add_dephasing_noise', 'add_amplitude_damping_noise'
]
