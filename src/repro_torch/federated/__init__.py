from repro_torch.federated.real import RealLearner
