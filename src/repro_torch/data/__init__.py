"""repro_torch.data — Table-1-shaped synthetic graphs (R-MAT) and
synthetic LM token streams."""
from repro_torch.data.graphs import (DATASETS, GraphDataset, dataset_names,
                                     make_dataset, rmat_edges)
from repro_torch.data.tokens import synthetic_lm_batch, token_stream

__all__ = ["DATASETS", "GraphDataset", "dataset_names", "make_dataset",
           "rmat_edges", "synthetic_lm_batch", "token_stream"]
