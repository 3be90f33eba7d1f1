"""The telemetry stream's declared schema (``obs_schema``, a copy of
the JAX package's registry). The JAX package's static-analysis passes
lint that package and are not ported."""
