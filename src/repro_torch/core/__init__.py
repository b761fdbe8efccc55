"""Core math of the port: Gaussian kernels, reductions, PLUGIN, synopses,
the closed-form AQP paths, confidence intervals, the query engine and its
admission sessions.

Public API (counterpart: `repro/core/__init__.py`'s AQP names):
  AqpQuery, QueryEngine, AqpResult, PlanCache   — the declarative AQP engine
  Range, Box, Eq, GroupBy                       — AqpQuery predicate terms
  AqpSession, AdmissionQueue, AdmissionFull     — admission and micro-batch
                                                  scheduling over QueryEngine
"""
from .aqp_admission import (DEFAULT_PRIORITY_TIERS, AdmissionFull, AdmissionQueue,
                            AqpSession)
from .aqp_query import AqpQuery, AqpResult, Box, Eq, GroupBy, PlanCache, QueryEngine, Range

__all__ = [
    "AqpQuery", "AqpResult", "QueryEngine", "PlanCache", "Range", "Box", "Eq", "GroupBy",
    "AqpSession", "AdmissionQueue", "AdmissionFull", "DEFAULT_PRIORITY_TIERS",
]
