from repro_torch.metrics.classification import (
    accuracy, confusion_matrix, classification_report)
