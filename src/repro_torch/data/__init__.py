from repro_torch.data.synthetic import (
    make_synthetic_cifar, partition_positive_labels, partition_iid)
