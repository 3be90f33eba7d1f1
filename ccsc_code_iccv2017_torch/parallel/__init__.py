"""Learners' outer loops (single device; meshes wait for ROADMAP.md item 8c)."""
