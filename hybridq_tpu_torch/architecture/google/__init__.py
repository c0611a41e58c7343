from hybridq_tpu_torch.architecture.google import sycamore

__all__ = ['sycamore']
