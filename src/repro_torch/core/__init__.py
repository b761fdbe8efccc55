"""Core math of the port: Gaussian kernels, reductions, PLUGIN, synopses,
the closed-form AQP paths, confidence intervals and the query engine."""
