"""The telemetry store: reservoirs, sketches, the synopsis cache."""
