"""The LM side of the port: so far ``juno_attention``, JUNO's ANN search
applied to the KV cache of decode-time attention (PQ-indexed keys, an
approximate scan, exact attention over the top-C positions)."""
from .juno_attention import (KVIndex, build_kv_index,  # noqa: F401
                             draw_kv_init, encode_step,
                             juno_decode_attention, kv_index_from_arrays,
                             traffic_model)
