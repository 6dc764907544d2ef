from repro_torch.data.lm_synthetic import MarkovLM
from repro_torch.data.partition import dirichlet_partition, leaf_style_partition
from repro_torch.data.synthetic import FederatedDataset, make_femnist_like
from repro_torch.data.virtual import VirtualFederatedDataset

__all__ = [
    "FederatedDataset",
    "MarkovLM",
    "make_femnist_like",
    "dirichlet_partition",
    "leaf_style_partition",
    "VirtualFederatedDataset",
]
