"""Serving steps of the LM stack (counterpart: `repro/train/`; the train
step waits for the training half)."""
from .serve_step import greedy_generate, make_decode_step
