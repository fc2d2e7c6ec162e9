from repro_torch.data.pipeline import PipelineConfig, batch_iterator, make_batch
from repro_torch.data.sparse import accuracy, hinge_loss, make_sparse_dataset

__all__ = ["PipelineConfig", "batch_iterator", "make_batch",
           "accuracy", "hinge_loss", "make_sparse_dataset"]
