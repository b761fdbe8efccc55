"""Training and serving steps of the LM stack (counterpart: `repro/train/`)."""
from .serve_step import greedy_generate, make_decode_step
from .train_step import make_eval_step, make_train_step, split_microbatches, train_params
