"""Knob tuning: the arm space (space), the tuned-knob store (store) and
the resolver, numerics guard and sweep (autotune; also the CLI
``python -m ccsc_code_iccv2017_torch.tune.autotune``)."""
