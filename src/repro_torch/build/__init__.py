"""Reading index artifacts written by ``repro.build.store.save_index``."""
from .store import (ArtifactError, LoadedIndex, index_from_arrays,  # noqa: F401
                    load_index, read_artifact)
