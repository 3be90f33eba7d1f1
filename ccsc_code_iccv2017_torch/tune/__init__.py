"""Knob tuning (ROADMAP.md Queue 1 item 9). Only the store's shape keys
are ported, for the perf ledger (analysis.ledger); the autotuner, its
arm space and the tuned-knob store wait for item 9."""
