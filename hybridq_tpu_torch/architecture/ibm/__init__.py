from hybridq_tpu_torch.architecture.ibm import rochester, eagle

__all__ = ['rochester', 'eagle']
