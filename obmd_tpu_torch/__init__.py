"""obmd_tpu_torch — the OBMD engine in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of `obmd_tpu` (JAX + Pallas for the TPU), which stays the reference.
This package imports torch and numpy only — never JAX, never `obmd_tpu`.
Module names mirror the reference's, so each counterpart is easy to find;
the two TPU kernels on the main path live in `forces/pair_kernel.py` and
`forces/usher_kernel.py`, each beside its plain PyTorch version.

Entry points take `device=` ("cuda" by default; asking for the card on a
machine without one raises).  Quick start:

    from obmd_tpu_torch import scenes
    from obmd_tpu_torch.integrate import setup, equilibrate, make_run
    sc = scenes.obmd_dpd_scene(scale=1.0)
    state = setup(sc.cfg, sc.state)
    state = make_run(sc.cfg, 100)(state)
"""

__version__ = "0.1.0"
