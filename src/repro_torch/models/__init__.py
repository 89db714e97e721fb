"""The LM side of the port: the ten architectures' model code (``config``,
``params``, ``layers``, ``transformer`` with ``moe``, ``mla`` and
``mamba2``, ``whisper``, ``api``) and
``juno_attention``, JUNO's ANN search applied to the KV cache of
decode-time attention (PQ-indexed keys, an approximate scan, exact
attention over the top-C positions)."""
from .api import (ModelAPI, cache_from_reference, get_model,  # noqa: F401
                  params_from_reference, train_state_from_reference)
from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig  # noqa: F401
from .juno_attention import (KVIndex, build_kv_index,  # noqa: F401
                             draw_kv_init, encode_step,
                             juno_decode_attention, kv_index_from_arrays,
                             traffic_model)
from .params import Spec, init_params  # noqa: F401
