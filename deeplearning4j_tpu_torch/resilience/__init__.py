"""Resilience (port of ``deeplearning4j_tpu/resilience``): deterministic
fault injection at named sites of the real code paths
(:mod:`~deeplearning4j_tpu_torch.resilience.faults`). The checkpoint
pipeline, the retry and preemption policy and the elastic fleet come
with later slices.
"""
from deeplearning4j_tpu_torch.resilience import faults as faults
from deeplearning4j_tpu_torch.resilience.faults import (FaultPlan,
                                                        FaultRule,
                                                        InjectedFault,
                                                        NAMED_PLANS)

__all__ = ["faults", "FaultPlan", "FaultRule", "InjectedFault",
           "NAMED_PLANS"]
