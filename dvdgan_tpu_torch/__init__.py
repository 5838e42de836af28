"""dvdgan_tpu_torch — the DVD-GAN of `dvdgan_tpu` in PyTorch, for an NVIDIA
H100.

The JAX package `dvdgan_tpu` is the reference; this package keeps its module
names, its parameter paths ("levels/0/gru/gates_x/w") and its layouts
(channels-last, time-major (T, B, H, W, C) inside G, HWIO conv kernels), so
each function here has a counterpart there that the tests hold it against.
It imports torch and never jax.

Every Pallas kernel on a ported path is a CUDA kernel written by hand for
sm_90a (`kernels/`), built with nvcc at first use. What is ported so far is
EMA-G sampling (`train.step.sample`, `python -m dvdgan_tpu_torch --mode
sample`), the alternating G/D train step with DS, DT, Adam and EMA
(`train.step.train_step`), with grad accumulation and per-level remat for
the long-clip preset, and the trainer that runs it on the reference's
schedule with checkpoints and auto-resume (`train.trainer`,
`train.checkpoint`, `--mode train`), and the evaluation: FVD, video IS and
frame FID of EMA-G samples with I3D, C3D and Inception-v3 (`eval`,
`--mode eval`, `--eval_step`), and training over several ranks with data
and time parallelism (`parallel`, `--n_devices`, `--time_shards`,
`--multihost`); ROADMAP.md lists the rest.
"""
