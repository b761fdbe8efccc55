"""Optimiser and gradient compression of the LM stack's training half
(counterpart: `repro/optim/`)."""
