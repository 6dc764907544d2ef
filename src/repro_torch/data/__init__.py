from repro_torch.data.synthetic import FederatedDataset, make_femnist_like

__all__ = ["FederatedDataset", "make_femnist_like"]
