"""Index artifacts written by ``repro.build.store.save_index`` (reader),
the fold of minor delta generations (``merge``) and the online rebuild of
a mutable index (``rebuild``)."""
from .merge import fold_step  # noqa: F401
from .rebuild import live_points, rebuild_index  # noqa: F401
from .store import (ArtifactError, LoadedIndex, index_from_arrays,  # noqa: F401
                    load_index, read_artifact)
