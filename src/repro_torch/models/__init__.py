"""The LM stack's models (counterpart: `repro/models/`): dense, VLM and MoE
transformers, Mamba-1, the Zamba2 hybrid and the Whisper encoder-decoder,
forward, prefill and decode.  They reach no hand kernel: the reference's
LM stack reaches no `pallas_call`."""
from .api import (batch_specs, batch_struct, build_model, cache_specs_with_dp, decode_struct,
                  param_specs_with_dp, param_structs, random_inputs)
