"""The plain reference that decides ``correct``.

Straightforward PyTorch, in float64 by default, written from the CCSC
reference's MATLAB scripts and imported by nothing of the program:

- :mod:`.fourier`: the FFT plumbing (padding, psf2otf, the filter
  projection);
- :mod:`.inpaint`: the 2D inpainting solve of
  ``2D/Inpainting/reconstruct_2D_subsampling.m`` (ADMM over v1 = Dz and
  v2 = z, the Sherman-Morrison z-solve, its own stop test);
- :mod:`.consensus`: the consensus learner's outer step of
  ``admm_learn_conv2D_large_dzParallel.m`` (block-local codes: the
  d-pass with its Woodbury solve and consensus average, the z-pass, the
  objective).

Every spectrum, Gram and factor is worked out here from the bank, the
images and the initial state the harness made; nothing the program
derived is read.
"""
