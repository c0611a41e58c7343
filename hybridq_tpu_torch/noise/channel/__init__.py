"""Channels subpackage."""

from hybridq_tpu_torch.noise.channel import channel, utils
from hybridq_tpu_torch.noise.channel.channel import *  # noqa: F401,F403
from hybridq_tpu_torch.noise.channel.utils import *  # noqa: F401,F403
