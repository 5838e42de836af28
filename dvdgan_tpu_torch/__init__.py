"""dvdgan_tpu_torch — the DVD-GAN generator of `dvdgan_tpu` in PyTorch, for
an NVIDIA H100.

The JAX package `dvdgan_tpu` is the reference; this package keeps its module
names, its parameter paths ("levels/0/gru/gates_x/w") and its layouts
(channels-last, time-major (T, B, H, W, C) inside G, HWIO conv kernels), so
each function here has a counterpart there that the tests hold it against.
It imports torch and never jax.

Every Pallas kernel on a ported path is a CUDA kernel written by hand for
sm_90a (`kernels/`), built with nvcc at first use. What is ported so far is
EMA-G sampling (`train.step.sample`, `python -m dvdgan_tpu_torch --mode
sample`); ROADMAP.md lists the rest.
"""
