from repro_torch.data.synthetic import FederatedDataset, client_num_samples
