"""The benchmark's yardstick: the card's published peaks and the work of a
request counted from its shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
"""

from __future__ import annotations

__all__ = ['PEAKS', 'peaks', 'state_bytes', 'evolution_bytes']

# name words -> (bytes/s of HBM, float32 FLOP/s outside the tensor cores,
#                TF32 FLOP/s on the tensor cores)
PEAKS = {'H100': (3.35e12, 67e12, 495e12)}


def peaks(device_name: str):
    """``(bytes_per_s, fp32_flops, tf32_flops)`` of the card named
    ``device_name``; raises for a card the table does not hold."""
    for key, val in PEAKS.items():
        if all(word in device_name for word in key.split()):
            return val
    raise KeyError(f"no published peaks for {device_name!r}")


def state_bytes(n: int) -> int:
    """Bytes of a complex64 state of ``n`` qubits."""
    return 8 * 2 ** n


def evolution_bytes(n: int, launches: int, calls: int = 1) -> int:
    """The least bytes that ``calls`` calls of ``simulate`` of the
    evolution engine move with ``launches`` gate launches in all: each
    launch reads and writes the state once, and each call's conversion of
    the result reads the split container and writes the complex state."""
    return 2 * state_bytes(n) * (launches + calls)
