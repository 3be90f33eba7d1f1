"""Learners' outer loops (consensus, streaming) and the meshes they run on (mesh, distributed)."""
