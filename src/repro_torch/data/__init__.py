"""Synthetic datasets of the port: ANN points (``synthetic``) and LM
token batches (``tokens``)."""
from .synthetic import (DEEP_LIKE, SIFT_LIKE, TTI_LIKE,  # noqa: F401
                        DatasetSpec, make_dataset, point_chunks)
from .tokens import make_batch  # noqa: F401
