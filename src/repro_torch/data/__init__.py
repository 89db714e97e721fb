"""Synthetic datasets of the port."""
from .synthetic import (DEEP_LIKE, SIFT_LIKE, TTI_LIKE,  # noqa: F401
                        DatasetSpec, make_dataset, point_chunks)
