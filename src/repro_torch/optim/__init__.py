from repro_torch.optim.optimizers import (Optimizer, adam, momentum, sgd,
                                          server_optimizer)
