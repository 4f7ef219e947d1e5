from repro_torch.data.augment import augment_batch, normalize
from repro_torch.data.synthetic import (
    make_synthetic_cifar, partition_positive_labels, partition_iid)
from repro_torch.data.tokens import synthetic_token_stream
