"""The allocator's peak over the window, over the bytes of the complex64
state."""


def read(record):
    size = record.costs.get('state_bytes')
    if not size or not record.peak_bytes:
        return None
    return record.peak_bytes / size
