from coala_gnn_tpu_torch.distribution.distributor import (
    SeedDistributor, greedy_affinity_assign)
from coala_gnn_tpu_torch.distribution.scheduler import DistributionScheduler

__all__ = ["SeedDistributor", "greedy_affinity_assign",
           "DistributionScheduler"]
