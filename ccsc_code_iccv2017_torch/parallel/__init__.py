"""Learner drivers (single device; meshes wait for ROADMAP.md item 8)."""
