from repro_torch.optim.sgd import sgd_momentum
from repro_torch.optim.schedule import constant_lr, cosine_lr, multistep_lr
