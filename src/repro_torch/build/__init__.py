"""Offline construction and persistence: the streaming (out-of-core)
build (``pipeline``), index artifacts (``store``: the writer, the reader
and the versioned store), the fold and the on-disk format of minor delta
generations (``merge``) and the online rebuild of a mutable index
(``rebuild``)."""
from .merge import (commit_minor, fold_step, load_minor,  # noqa: F401
                    minor_codes_loader, save_minor)
from .pipeline import (BuildProbe, StreamDraws, array_source,  # noqa: F401
                       build_streaming, build_streaming_sharded, merge_shards,
                       split_shards)
from .rebuild import live_points, rebuild_index  # noqa: F401
from .store import (ArtifactError, ArtifactStore, LoadedIndex,  # noqa: F401
                    config_hash, index_from_arrays, load_index, save_index,
                    verify_artifact)
