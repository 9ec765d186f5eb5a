"""Innovation + belief step of Algorithm 3, per agent j: draw a private
signal by inverse CDF, add its log-likelihood row to the accumulator z, and
take the KL-proximal belief softmax(z / mass).

:mod:`.ref` is the plain PyTorch version and :mod:`.ops` the route dispatch
and the CUDA kernel's wrapper.
"""
from .ops import innovation_cuda, innovation_step, staged_agents
from .ref import innovation_ref, sample_signals

__all__ = ["innovation_step", "innovation_cuda", "innovation_ref",
           "sample_signals", "staged_agents"]
