from hybridq_tpu_torch.architecture.rigetti import aspen_7, aspen_11

__all__ = ['aspen_7', 'aspen_11']
