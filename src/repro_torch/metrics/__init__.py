from repro_torch.metrics.classification import (
    accuracy, confusion_matrix, classification_report, f1_macro,
    precision_at_1, recall_macro)
