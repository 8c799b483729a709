"""repro_torch.data — Table-1-shaped synthetic graphs (R-MAT)."""
from repro_torch.data.graphs import (DATASETS, GraphDataset, dataset_names,
                                     make_dataset, rmat_edges)

__all__ = ["DATASETS", "GraphDataset", "dataset_names", "make_dataset",
           "rmat_edges"]
